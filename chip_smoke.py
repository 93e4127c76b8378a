#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. setup: the card's name and power limit, torch and CUDA versions, TF32
     off for matmuls and cuDNN;
  2. build the eleven CUDA libraries from src/repro_torch/csrc (one nvcc
     each, all started together) into build/torch_kernels/, count the
     tensor-core instructions in the SASS of the bf16 flash library (HGMMA,
     also in its D 320 instance alone), of the tensor-core flash backward's
     D 64, D 128 and D 320 instances (HGMMA, with ptxas's registers and
     spills of each) and of the bf16 gla_scan forward and backward
     libraries (HMMA),
     and print ptxas's registers and spills of both flash libraries' D 320
     instances and of both gla_scan backwards' kernels (the CUDA-core one
     with its most registers and spills over all 54 instances);
  3. each kernel against its plain PyTorch version at the main paths'
     shapes (flash and paged also at granite-MoE's, DBRX's,
     qwen2_vl_72b's, qwen2p5_14b's (G 5) and starcoder2_7b's (G 9) heads,
     the last three from generators of their own; at G 5 and G 9 paged
     beside SDPA over the same K/V laid out dense, and each wrapper's host
     time):
     max |err| beside the tolerance, and kernel, plain, library
     (where one call computes the same function) and bound times; flash
     and gla_scan on both routes (bf16 on the tensor cores, fp32 and the
     shapes the tensor-core gla_scan does not take on CUDA cores); paged
     on its cluster-split route at the decode shape and at a long context
     (up to 32768 positions), beside the CUDA-core kernel it replaced; the
     dense decode attention kernel against its plain body at the benchmark
     cells' shapes (StarCoder2-7B's B 32 over a cache of 3904, Qwen2.5-14B's
     B 4 over 4128) and a window ring, bf16 and fp32, at valid 1, 17, one
     short of the cache and the full cache, one CUDA graph a shape replayed
     at two lengths bit-equal to eager calls, and beside SDPA over the live
     positions; the host time of one wrapper call of each kernel at its
     main-path shape;
     flash also at SeamlessM4T's four uses (encoder, decoder
     self-attention, cross-attention at prefill and at decode, Sq 1) and at
     gemma3_4b's (D 320, with its window of 1024 and without, bf16 and
     fp32; SDPA timed with the window as a mask and its backend named),
     each drawn from a generator of its own; the flash backward against
     attention_bwd_ref at TinyLlama's training shape (B 8, S 2048),
     granite's G 3, qwen2_vl_72b's G 8 at D 128, gemma3_4b's training
     calls (B 1, S 2048, D 320) with its window and without, SeamlessM4T's
     encoder and cross-attention training calls (no mask, Sq 1024 and 256
     over Sk 1024), Sq != Sk at a q_offset and in fp32, each on
     the route the backward's rule names (bf16 on the tensor cores with
     the forward's lse, fp32 on CUDA cores): max |err| over the largest
     |gradient| beside the tolerance, two calls bit-equal, kernel, plain
     and SDPA-backward times and the bound (2.5x the forward's
     operations), and on the tensor-core rows the CUDA-core kernel's time
     and error beside them; at D 320 also each 64-key tile of dK and dV
     and each 64-column block of dQ against its own largest |gradient|,
     with two planted faults (the last key tile's dK/dV zeroed, dK's last
     64 columns zeroed) that must fail that gate; the gla_scan backward against
     gla_scan_bwd_ref at RWKV6's training shape (B 8, H 64, S 2048, K = V
     = 64, bf16), Zamba2's (one decay per head, stride-0 w), a ragged S,
     strong decay (these four on the tensor cores) and fp32 at K = V = 32
     (on CUDA cores), each on the route the backward's rule names: max
     |err| over the largest |gradient| beside the tolerance, two calls
     bit-equal, kernel, plain and bound times (no library time), and on the
     tensor-core rows the CUDA-core kernel's time and error beside them;
     then reduced TinyLlama, granite-MoE, DBRX, qwen2_vl_72b (with an embeds
     prefix), Qwen2.5-14B, StarCoder2-7B, RWKV6, Zamba2, SeamlessM4T and
     gemma3_4b (with a tail)
     models on the card (the kernels) held against the CPU path (their
     plain versions) in fp32, for the MoE family with its load-balance loss
     (and, once, a MoE layer that drops tokens), and reduced TinyLlama's,
     granite-MoE's, RWKV6's, Zamba2's, gemma3_4b's (with a tail and a
     window), SeamlessM4T's (with seeded frames) and qwen2_vl_72b's (with
     an embeds prefix) loss_fn and every gradient leaf (the forward and
     backward kernels of flash and gla_scan, launches counted) the same
     way;
  4. the TinyLlama path: full-width TinyLlama (random weights from the
     seed) -- prefill of 8 x 512 tokens through the bf16 flash kernel, dense
     decode (every step's attention through the dense decode kernel, counted
     eager and at the graph's capture), then paged decode through the paged kernel (every launch on
     the split route) from a pool laid out under a shuffled block table,
     held against the dense decode; then both decode steps captured in CUDA
     graphs (serve.engine.DecodeGraph) and replayed over the same steps from
     the same cache, their logits equal to the eager ones bit for bit;
  5. BatchScheduler serving 16 requests over 4 slots at full width, with
     its decode step captured (the default on a card) and eager, the same
     tokens from both;
  6. PagedKVEngine: real K pages of the card's pool spill to the DDS page
     store (host path) and come back bit-exact through the DPU offload path;
  7. rwkv6_7b at full width and depth: prefill of 8 x 512 tokens (one
     gla_scan launch per layer, each on the tensor-core route), 8 decode
     steps through the recurrence,
     each held against the last logits of a prefill of the longer prompt,
     the same steps replayed from a CUDA graph (the new state copied into
     the captured buffers), then BatchScheduler serving, captured and
     eager;
  8. zamba2_1p2b at full width and depth: the same, with the shared
     attention block through the flash kernel once per group;
  9. granite_moe_3b_a800m at full width and depth through phase 4's path
     (prefill, dense and paged decode eager and captured, profiles), with
     the tokens whose top-K expert sets differ between the dense and the
     paged step counted per layer, then BatchScheduler as in phase 5;
 10. dbrx_132b at full width with 4 of its 40 layers through the same
     path, and its peak device memory during init and during the run;
 11. seamless_m4t_medium at full width and depth: 8 x 512 frames encoded
     and a decoder prompt of 64 tokens prefilled (36 flash launches on the
     tensor-core route), 8 decode steps eager and from a CUDA graph (12
     flash launches a step, at Sq 1), each held against the last logits of
     a prefill of the longer prompt over the same frames, the same steps
     with every sequence's cross K/V swapped for its neighbour's (a planted
     fault that must fail that limit), profiles, BatchScheduler captured
     and eager, and the peak device memory;
 12. gemma3_4b at full width and depth (29 window layers and 5 global
     ones, head dim 320): prefill of 8 x 1536 tokens into a 2048-position
     cache (34 flash launches on the tensor-core route, 29 with the window
     of 1024, 5 without), 8 decode steps eager and from a CUDA graph, each
     held against the last logits of a prefill of the longer prompt and
     the cache they leave against that prefill's (every ring slot), the
     same steps from a ring rolled one slot (a planted fault that must fail
     that test), profiles, BatchScheduler captured and eager, and the peak
     device memory;
 13. qwen2_vl_72b at full width with 24 of its 80 layers (M-RoPE, an
     embeds prefix of 512 patch rows): its peak device memory during init
     (held to the weights plus one layer), then phase 4's path with the
     prefix (prefill of 8 x 2048 into 2304 positions: 24 flash launches on
     the tensor-core route; dense and paged decode, 24 paged launches a step
     on the split route, eager and captured; profiles against the step's
     weights and K/V read once), the dense steps held against the last
     logits of a prefill of the longer prompt over the same prefix, the
     same steps after a prefill whose prefixes are rolled one sequence (a
     planted fault that must fail that limit), BatchScheduler captured and
     eager, and PagedKVEngine over its 256 KiB K pages;
 14. TinyLlama training at full width and depth, B 8 x 2048 from the
     structured token stream: the first step's attention gradients through
     the kernels held against the plain attention path on the card (three
     planted faults of the backward read, two of which must fail that
     limit), one step with microbatch 2 against 1, then 40 Trainer steps
     (loss, grad norm, lr, ms, 44 forward launches on wgmma and 22
     backward launches on wgmma a step; the mean loss of the last 5 must be below
     that of the first 5), a checkpoint of {params, mu, nu} (11.0 GB)
     through the DDS server with the Trainer's save_async after step 34,
     restored bit-exact into a fresh Trainer, which runs on to step 40
     under a TrainSupervisor of 4 hosts that loses one at step 37, restores
     the step-34 checkpoint from the DDS store and replays (one restart,
     one host dropped; every loss, the replayed ones too, equal to the
     uninterrupted run's bit for bit), then one step profiled (device busy
     and idle share, largest items, the port's kernels and the flash
     backward's share); then the remat="dots" policy (selective activation
     checkpointing that keeps the projections' outputs): one batch's
     gradients at "dots" against "full" from the same params, and 3
     Trainer steps at each from the same params and batches (ms, peak
     memory, launches; one "dots" step profiled);
 15. the gated-linear-attention family trains: zamba2_1p2b at full width
     and depth and rwkv6_7b at full width with 6 of its 32 layers, B 8 x
     2048 from the structured token stream: the first step's gradients of
     the leaves that feed the scan (RWKV6: wd_a, wd_b, w_k, w_v; Mamba2:
     in_bc, in_xz, in_dt, A_log) and the global norm through the kernels
     held against the plain GLA path on the card (two planted faults of
     the backward must fail that limit), then 10 Trainer steps (loss, grad
     norm, ms, peak memory, launches by route a step: RWKV6 12 forward and
     6 backward on mma; Zamba2 74 and 38, with flash 12 forward and 6
     backward on wgmma) and one profiled step (device busy and idle
     share, largest items, the gla_scan backward's share);
 16. gemma3_4b and seamless_m4t_medium train at full width and depth:
     gemma3_4b (34 layers, D 320) at B 8 x 2048 from the structured
     stream in 8 microbatches of 1 on the in-place Trainer, SeamlessM4T
     (12 + 12 layers) at B 8 with 1024 seeded frames and 256 target tokens
     through the in-place make_train_fn; for each the first (micro)batch's
     attention gradients through the kernels held against the plain
     attention path (the planted faults of phase 14, two of which must fail
     that limit), then 10 steps (loss, grad norm, ms, peak memory, which
     must fit the card, and flash launches by route a step: gemma3_4b 8 x
     (68 forward and 34 backward), SeamlessM4T 72 and 36, all on wgmma) and
     one profiled step (device busy and idle share, largest
     items, the flash backward's ms and share of busy time);
 17. the sharded entry points on a 1 x 1 ("data", "model") mesh over a
     NCCL world of one (launch.mesh.make_test_mesh): phase 4's TinyLlama
     weights through make_serve_fns' prefill (8 x 512 into 1024, 22 flash
     launches on wgmma) and 8 dense decode steps, held to phase 4's eager
     logits; then TinyLlama at full width and depth, B 8 x 2048 from the
     structured stream, 3 steps of make_train_step's function against 3
     of the single-device out-of-place make_train_fn from the same params,
     moments and batches (loss, grad norm and params held to a limit,
     bit-equal expected; 44 forward and 22 backward flash launches a step
     on wgmma; peak memory within the card), and one profiled sharded
     step: wall, device busy and idle share beside phase 14's step; (a)
     make_serve_fns' decode step captured in a DecodeGraph on DTensors
     placed by its in_specs, 8 replayed steps whose logits equal the eager
     sharded steps' bit for bit, ms a step beside the eager sharded step
     and phase 4's captured step, one profiled replay; (b)
     make_compressed_pod_train_fn on a (pod 1, data 1, model 1) mesh, 3
     steps against 3 of the single-device make_train_fn(
     compress_pod_grads=True) from the same params, moments and residuals
     (loss, grad norm, params and residuals held to a limit, bit-equal
     expected; 44 forward and 22 backward flash launches a step on wgmma;
     peak memory within the card); between the two, one make_train_step
     step at remat="dots" against the first sharded step (loss and grad
     norm held to the same limit);
 18. the dry run (python -m repro_torch.launch.dryrun, a fake process group
     of the 16 x 16 mesh's 256 ranks, fake tensors) of TinyLlama x
     train_4k and x decode_32k with 2 layers, each in a subprocess under a
     time limit: every record status ok; per-rank argument and temp bytes
     beside HBM_PER_GPU, collectives by kind and the dominant roofline term
     (analysis, not speed);
 19. qwen2p5_14b at full width and depth (48 layers, 40/8 heads of 128:
     G 5, QKV bias; 29.5 GB of bf16 weights) through phase 4's path
     (prefill 8 x 512 into 1024: 48 flash launches on wgmma; dense and
     paged decode, every paged launch on the split route, eager and
     captured; profiles beside the weights read once), then the paged
     steps with each sequence's first page dropped (a planted fault that
     must fail the paged-vs-dense limit), the dense steps against the last
     logits of a prefill of the longer prompt, BatchScheduler captured and
     eager, and the peak device memory;
 20. starcoder2_7b at full width and depth (32 layers, 36/4 heads of 128:
     G 9; LayerNorm with biases, plain GELU, QKV bias; 14.8 GB) the same
     way.
The second-to-last line is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
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
H100_FP32_FLOPS = 67e12         # fp32 on CUDA cores, H100 SXM data sheet
# The port's kernels (src/repro_torch/csrc/*.cu), as the profiler names them.
PORT_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_kernel",
                "flash_bwd_delta_kernel", "flash_bwd_wgmma_dkdv_kernel",
                "flash_bwd_wgmma_dkdv_split_kernel", "flash_bwd_wgmma_dq_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                "paged_attention_split_kernel", "paged_attention_kernel",
                "decode_attention_split_kernel",
                "gla_scan_mma_kernel", "gla_scan_kernel", "gla_bwd_mma_states_kernel",
                "gla_bwd_mma_kernel", "gla_bwd_scan_kernel", "gla_bwd_dqk_kernel",
                "gla_bwd_dv_kernel")
# The route every bf16 prefill launch of a kernel must take.
PREFILL_ROUTES = {"flash_attention": "wgmma", "gla_scan": "mma"}
TOL_BF16 = 2e-2                 # kernel vs plain version, bf16 in and out
# Paged at the long context (16384-32768 positions) vs its plain version:
# there a typical output is about sqrt(e / context) ~ 0.009, so 2e-2 would
# pass a kernel that dropped a cluster rank's pages (about 0.003 typical,
# 0.013 at most).  An H100 measured 1.2e-4 (one bf16 rounding of the
# output); this sits between that and the typical output.  The dense
# decode kernel takes it from ``LONG_DECODE`` live positions on: at 3903-
# 4128 (randn q/k/v, D 128) the output is about 0.02, a kernel that skipped
# or read twice one 16-position unit errs by 0.011 or more, and an H100
# measured 4.9e-4; on a ring of 1000 the output is about 0.035 and such a
# kernel errs by 0.037 or more.
TOL_PAGED_LONG = 2e-3
LONG_DECODE = 1000
# fp32: the reduced models on the card vs the CPU path, and flash's fp32
# route vs its plain version
TOL_FP32 = 1e-4
# qwen2_vl_72b (24 of 80 layers, phase 13, 8 steps after a 2048-token
# prompt whose first 512 positions are the embeds prefix): paged against
# dense decode logits, and prefill(S) + n dense steps against prefill(S + n)
# over the same prefix.  An H100 measured at most 0.0879 and 0.1016 over
# seeds 0-3 (scripts/vlm_cont_gate.py; mean |logit| 0.80), and at least
# 7.0469 with every sequence given its neighbour's prefix (the planted
# fault of phase 13); these allow 3.5 times the first two.
VLM_TOL_PAGED = 0.31
VLM_TOL_CONT = 0.36
# Paged against dense decode of the full model in bf16: the two attention
# paths round differently and the difference grows through the layers.
# TinyLlama (22 layers): an H100 measured 0.072 at seed 0, and this allows
# 3.5 times that.  The MoE family also routes on the rounded values, and a
# token whose top-K expert set flips between the two paths moves by a
# whole expert's share, not by drift.  With the reference's expert init
# (E^-0.5, ROADMAP.md Queue 3) the MoE output dwarfs the residual stream,
# so each flip moves the logits by O(1) and flips beget flips with depth.
# An H100 measured 5.0312 (granite, 32 layers: 1138 of 2048 (step, token,
# layer) top-8 sets flipped, 0 in layer 0 and 54 of 64 in the last) and
# 3.0234 (dbrx, 4 layers: 8 of 256 top-4 sets) at seed 0; these allow 3.5
# times that.  For the MoE family this limit cannot tell a wrong paged
# kernel from a flip: TOL_PAGED_PINNED is the gate that can.
# qwen2p5_14b (48 layers, G 5) and starcoder2_7b (32 layers, G 9) at
# phases 19-20's draw (seed 0): an H100 measured 0.1094 and 0.0625, and
# 2.5156 and 1.0071 with each sequence's first page dropped (the planted
# fault of dense_path); these allow 3.5 times the first two.
TOL_PAGED_LOGITS = {"tinyllama_1p1b": 0.25, "granite_moe_3b_a800m": 17.6,
                    "dbrx_132b": 10.6, "qwen2_vl_72b": VLM_TOL_PAGED,
                    "qwen2p5_14b": 0.38, "starcoder2_7b": 0.22}
# The same comparison with each layer's experts pinned to the dense path's,
# so that no flip moves a token: the attention paths' rounding, carried
# through layers whose MoE outputs are large.  An H100 measured 0.4570
# (granite) and 0.1094 (dbrx) at seed 0; these allow 3.5 times that.  Over
# five more draws of weights (scripts/moe_paged_gate.py, seeds 0-3, and
# this script) it read at most 0.4434 and 0.1719, at a mean |logit| of
# 0.80, and the paged kernel run without each sequence's first page (the
# planted fault of moe_routing, which main_path requires to fail this
# limit) at least 6.6562 and 5.8438.
TOL_PAGED_PINNED = {"granite_moe_3b_a800m": 1.6, "dbrx_132b": 0.38}
# The MoE family on the card: granite at full width and depth; dbrx at full
# width with 4 of its 40 layers (its 132 B bf16 weights are about 264 GB).
MOE_ARCHS = ("granite_moe_3b_a800m", "dbrx_132b")
DBRX_LAYERS = 4
# The DDS page store's page payload for KV paging: 64 KiB, one TinyLlama K
# page.  The storage server splits a write larger than half its 256 KiB
# request ring, and caches for the DPU only pages one write covers whole, so
# a larger K page (qwen2_vl_72b's is 256 KiB) spans several store pages.
KV_STORE_PAYLOAD = 1 << 16
# GLA scan kernel against its plain version, as the JAX package's GLA
# tests compare (tests/test_kernels.py): atol = rtol = 4 x {fp32 2e-5,
# bf16 2e-2} on the output (which reaches O(100) at S 512, where one bf16
# step is 0.5, so an absolute bound alone would not do) and 1e-3 on the
# final fp32 state.
TOL_GLA = {torch.float32: 4 * 2e-5, torch.bfloat16: 4 * 2e-2}
TOL_GLA_STATE = 1e-3
# gla_scan at RWKV6's prefill shape on the CUDA-core kernel, the only one
# before the tensor-core route (this script on an H100 80GB HBM3 at 700 W;
# PERF.md, section 6).
GLA_SIMT_BEFORE_MS = 1.2745
# prefill(S) + n decode steps against the last logits of prefill(S + n), in
# bf16 at full depth: the chunked kernel and the recurrence round
# differently, as do the matmuls of one token and of a whole prompt.  An
# H100 measured at most 0.2578 (rwkv6_7b, 32 layers) and 0.0469
# (zamba2_1p2b) over two draws of seed-0 weights; these allow 3.5 times
# that, as TOL_PAGED_LOGITS does.
# seamless_m4t_medium (12 + 12 layers, 64-token prompt over 512 frames):
# the decode step's self-attention is the dense decode kernel over the
# cache (plain torch before it) where the prefill's is the flash kernel,
# its cross-attention the kernel at Sq 1 where the prefill's is at Sq
# 64 + n, and its matmuls have 8 rows.  An H100 measured at most 0.0469
# over seeds 0-3, plain torch in the decode step (scripts/seamless_cont_gate.py;
# mean |logit| 0.80), and at least 1.0449 with every sequence's cross K/V
# rolled to its neighbour's (the planted fault of phase 11); this allows
# 3.5 times the first.
# gemma3_4b (34 layers, a 1536-token prompt, rings of 1024): the decode
# step's attention is plain torch over the rings where the prefill's is the
# flash kernel with the window, and its matmuls have 8 rows.  An H100
# measured at most 0.1270 over seeds 0-3 (scripts/gemma3_cont_gate.py;
# mean |logit| 0.81), and at least 0.5342 with the first local ring rolled
# one slot (the planted fault of phase 12); this allows 3.5 times the first.
# qwen2p5_14b and starcoder2_7b (phases 19-20: 8 steps after a 512-token
# prompt): an H100 measured 0.1094 and 0.0625 at seed 0; these allow 3.5
# times that.
TOL_CONT_LOGITS = {"rwkv6_7b": 0.9, "zamba2_1p2b": 0.17,
                   "seamless_m4t_medium": 0.17, "gemma3_4b": 0.44,
                   "qwen2_vl_72b": VLM_TOL_CONT, "qwen2p5_14b": 0.38,
                   "starcoder2_7b": 0.22}
# gemma3_4b: the cache that prefill(S) + n decode steps leave against the
# cache of prefill(S + n), every ring slot and global position: rounding
# alone moves a key by a few bf16 steps, a slot that holds another position
# by a whole key.  An H100 measured at most 0.1094 over seeds 0-3 and at
# least 7.9062 with the planted fault; this allows 3.5 times the first.
TOL_CONT_CACHE = {"gemma3_4b": 0.38}
# qwen2_vl_72b, phase 13: full width (d 8192, 64/8 heads of 128, d_ff
# 29568, vocab 152064) with 24 of its 80 layers (the bf16 weights of all 80
# are about 145 GB; 24 are 47.1 GB), a prompt of 2048 whose first
# min(VLM_PATCH_TOKENS, 2048 // 4) = 512 positions are the embeds prefix,
# into a cache of 2304 (18 pages of 128).
VLM_LAYERS = 24
# What phase 13's init may hold beyond its weights and one layer (the
# layer being drawn before it is copied into its slot): the temporaries of
# drawing one matrix (its largest, 8192 x 29568 bf16, is 0.45 GiB; an H100
# measured 1.014 GiB over weights and layer) and allocator slack.  A list
# of layers stacked at the end would hold the weights twice.
INIT_SLACK = 2 * 2**30
VLM = dict(B=8, S=2048, cache_len=2304, steps=8, page=128)
# Phases 19-20: the dense configurations of the JAX package that had not
# run on the card, at full width and depth through phase 4's path
# (main_path at its defaults: prefill 8 x 512 into 1024, page 128):
# qwen2p5_14b (48 layers, d 5120, 40/8 heads of 128: G 5; QKV bias, vocab
# 152064; 29.5 GB of bf16 weights) and starcoder2_7b (32 layers, d 4608,
# 36/4 heads of 128: G 9, the split paged kernel's largest compiled G;
# LayerNorm with biases, plain GELU, QKV bias, vocab 49152; 14.8 GB).
DENSE_ARCHS = ("qwen2p5_14b", "starcoder2_7b")
# B, Sq, Sk, Hq, Hkv, D, use: their flash calls (phase 3: causal, S 512);
# label, Hq, Hkv, D: their paged calls at the decode shape (page 128, up to
# 1024 positions).  Both draw from generators of their own, so that the
# later cases and phases draw the same numbers as before they were added.
FLASH_DENSE = [(8, 512, 512, 40, 8, 128, "qwen2p5_14b prefill"),
               (8, 512, 512, 36, 4, 128, "starcoder2_7b prefill")]
PAGED_DENSE = [("qwen2p5_14b decode", 40, 8, 128),
               ("starcoder2_7b decode", 36, 4, 128)]
# label, B, S_cache, Hq, Hkv, D, timed length: the dense decode attention at
# the benchmark cells' shapes (portbench/workloads: starcoder2_7b.repo_decode
# B 32 over a cache of 3904, prompts of 3072-3840 and 64 out, timed at their
# mean live length; qwen2p5_14b.doc_prefill B 4 over 4128, prompts of
# 2048-4096 and 32 out), then a window ring of 1000 slots (not a multiple of
# 16) at the second's heads.  They draw from a generator of their own.
DECODE_DENSE = [("starcoder2_7b repo_decode", 32, 3904, 36, 4, 128, 3490),
                ("qwen2p5_14b doc_prefill", 4, 4128, 40, 8, 128, 3100),
                ("window ring", 4, 1000, 40, 8, 128, 1000)]
# seamless_m4t_medium, phase 11: frames, decoder prompt and decode steps.
SEAMLESS = dict(B=8, S_enc=512, S=64, steps=8)
# B, Sq, Sk, Hq, Hkv, D, causal, use: the flash calls of SeamlessM4T at
# phase 11's shapes (16 heads of 64, G 1, q_offset 0).
FLASH_SEAMLESS = [(8, 512, 512, 16, 16, 64, False, "encoder"),
                  (8, 64, 64, 16, 16, 64, True, "decoder self-attention"),
                  (8, 64, 512, 16, 16, 64, False, "cross-attention, prefill"),
                  (8, 1, 512, 16, 16, 64, False, "cross-attention, decode")]
# Reduced configs of check_reduced_api_against_cpu beyond reduced_config:
# gemma3_4b with a tail (5 layers in groups of 2) and a window of 6, so that
# its 16-token prompt wraps the rings (16 % 6 = 4) and the steps wrap them
# again.
REDUCED_CHANGES = {"gemma3_4b": dict(num_layers=5, group_size=2, window=6)}
# gemma3_4b, phase 12: a prompt longer than the window and off its grid
# (S % 1024 = 512, so the prefill's rings are rolled), a cache of 2048.
GEMMA = dict(B=8, S=1536, cache_len=2048, steps=8)
# B, Sq, Sk, Hq, Hkv, D, window, dtype name, use: the flash calls of
# gemma3_4b's prefill at phase 12's shape (8 heads of 320 over 4, causal).
FLASH_GEMMA = [(8, 1536, 1536, 8, 4, 320, 1024, "bfloat16", "local layers"),
               (8, 1536, 1536, 8, 4, 320, None, "bfloat16", "global layers"),
               (8, 1536, 1536, 8, 4, 320, 1024, "float32", "local layers"),
               (8, 1536, 1536, 8, 4, 320, None, "float32", "global layers")]


# B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, dtype name, use: the
# flash backward's cases of phase 3: TinyLlama's training call (phase 14),
# granite-MoE's and qwen2_vl_72b's heads, gemma3_4b's training calls (phase
# 16: a microbatch of 1 x 2048, D 320) with its window of 1024 and without,
# SeamlessM4T's (phase 16: the encoder's and the cross-attention's, both
# without a mask), Sq != Sk at a q_offset other than Sk - Sq, and fp32.
FLASH_BWD = [(8, 2048, 2048, 32, 4, 64, True, None, 0, "bfloat16", "tinyllama_1p1b training"),
             (8, 2048, 2048, 24, 8, 64, True, None, 0, "bfloat16", "granite_moe_3b_a800m heads"),
             (2, 2048, 2048, 64, 8, 128, True, None, 0, "bfloat16", "qwen2_vl_72b heads"),
             (1, 2048, 2048, 8, 4, 320, True, 1024, 0, "bfloat16", "gemma3_4b training, local layers"),
             (1, 2048, 2048, 8, 4, 320, True, None, 0, "bfloat16", "gemma3_4b training, global layers"),
             (8, 1024, 1024, 16, 16, 64, False, None, 0, "bfloat16", "seamless_m4t_medium training, encoder"),
             (8, 256, 1024, 16, 16, 64, False, None, 0, "bfloat16", "seamless_m4t_medium training, cross-attention"),
             (8, 256, 1024, 32, 4, 64, True, None, 700, "bfloat16", "Sq != Sk at q_offset 700"),
             (8, 512, 512, 32, 4, 64, True, None, 0, "float32", "fp32")]
# The flash backward against attention_bwd_ref on the same inputs, max |err|
# over the largest |gradient| (the kernel tests' 2e-2 and 2e-5): bf16 in and
# out, one rounding of each gradient; fp32 summation order.
TOL_BWD = {"bfloat16": 2e-2, "float32": 2e-5}
# Phase 17: the sharded entry points on a 1 x 1 mesh.  Serving: phase 4's
# prefill (B 8 x S 512 into 1024) and its first 8 dense decode steps.
# Training: TinyLlama at full width and depth, B 8 x 2048, 3 steps and a
# profiled fourth.
SHARDED = dict(S=512, cache_len=1024, decode=8, train_B=8, train_S=2048, steps=3)
# On one rank the sharded path runs the same kernels on the same tensors,
# so bit-equal results are expected; the limits allow a different choice
# of library kernel: logits within phase 4's paged-vs-dense limit, and
# loss, grad norm and params (over the largest |param|) within 1e-3.
TOL_SHARDED_LOGITS = 0.25
TOL_SHARDED_TRAIN = 1e-3
# Phase 18: the dry run (repro_torch.launch.dryrun) of these cells, each in
# a process of its own (its fake process group is that process's default
# group) under a time limit in seconds.
DRYRUN = dict(arch="tinyllama_1p1b", shapes=("train_4k", "decode_32k"),
              mesh="single", layers=2, timeout=400)
# Phase 14: TinyLlama at full width and depth, B 8 x S 2048 (its published
# context), 40 Trainer steps with a checkpoint after 34 (6 resumed).  At
# the reference's lr (3e-4, 2 warmup steps) 6 steps do not descend: an H100
# read 10.806 at step 0 and 10.978 at step 5, the early Adam steps raising
# the random logits' spread, and batches differ by about 0.1; over 40 steps
# the mean of the first 5 losses fell from 10.847 to 10.645 over the last 5.
# The resumed Trainer runs on under a TrainSupervisor of 4 hosts, which
# loses host3 at step 37, restores the step-34 checkpoint and replays; then
# 3 steps at each remat policy ("full", "dots") from the same params.
TRAIN = dict(B=8, S=2048, steps=40, ckpt_at=34, mean_of=5, hosts=4,
             crash={37: "host3"}, dots_steps=3)
# The gradient gate (train_gate): the first step's wq/wk/wv/wo gradients of
# every layer and the global norm through the kernels against the plain
# attention path (fp32 inside, bf16 out; the wgmma forward rounds P to bf16
# before P V), the worst ||g - g_plain|| / ||g_plain||.  An H100 measured
# 0.014298 at seed 0, and 20.07 with dq left unscaled and 0.8167 with the
# first key tile's dK/dV zeroed (the planted faults that must fail it);
# this allows 3.5 times the first.  The last key tile's dK/dV zeroed read
# 0.014295: its 64 keys are seen by the last 64 queries alone, too little
# gradient for this gate, so that fault is read and not required to fail.
TOL_TRAIN_GRADS = 0.05
# One step with microbatch 2 against 1 (micro_gate): bf16 gradients of the
# whole batch against the fp32 sum of two half batches' bf16 gradients.
# An H100 measured 0.0031252 at seed 0; this allows 3.5 times that.
TOL_TRAIN_MICRO = 0.011
# B, H, S, K, V, dtype name, decay, with the final state's gradient, route,
# use: the gla_scan backward's cases of phase 3 (chunk 128): RWKV6's
# training call (phase 15: no final-state gradient), Zamba2's Mamba2 call
# (one decay per head, broadcast over K with stride 0), a ragged S, strong
# decay (w = -2.5: the guard saturates), all on the tensor cores, and fp32
# at K = V = 32 on CUDA cores.
GLA_BWD = [(8, 64, 2048, 64, 64, "bfloat16", "rwkv6", False, "mma", "rwkv6_7b training"),
           (8, 64, 2048, 64, 64, "bfloat16", "mamba2", True, "mma", "zamba2_1p2b training"),
           (8, 64, 2000, 64, 64, "bfloat16", "rwkv6", True, "mma", "ragged S 2000"),
           (8, 64, 2048, 64, 64, "bfloat16", "strong", True, "mma", "strong decay"),
           (8, 64, 2048, 32, 32, "float32", "rwkv6", True, "simt", "fp32")]
# The gla_scan backward against gla_scan_bwd_ref, max |err| over the largest
# |gradient| (as TOL_BWD): bf16 one rounding of each gradient, fp32
# summation order.
TOL_GLA_BWD = {"bfloat16": 2e-2, "float32": 1e-4}
# Phase 15: zamba2_1p2b at full width and depth and rwkv6_7b at full width
# with RWKV6_TRAIN_LAYERS of its 32 layers (bf16 weights and gradients and
# fp32 moments of all 32 come to about 90 GB), B 8 x S 2048 from the
# structured stream, SSM_TRAIN["steps"] Trainer steps after the gate.
RWKV6_TRAIN_LAYERS = 6
SSM_TRAIN = dict(B=8, S=2048, steps=10)
# The gradient gate of phase 15 (ssm_train_gate): a step's gradients of the
# leaves that feed the scan's inputs, through the kernels (bf16 in and out,
# the mma forward's hi/lo roundings), against the plain GLA path
# (gla_scan_xla under autograd, fp32 inside), the worst ||g - g_plain|| /
# ||g_plain|| and the global norms' relative difference.  An H100 measured
# 0.0068225 (rwkv6_7b, at layer 3's wd_a) and 0.055082 (zamba2_1p2b, at
# group 4 layer 5's in_dt) at seed 0, and at least 0.98621 and 4.0052 with
# the planted faults of gla_bwd_faults; these allow 3.5 times the first two.
TOL_SSM_TRAIN_GRADS = {"rwkv6_7b": 0.024, "zamba2_1p2b": 0.19}
# The Trainer step whose gradients the gate reads.  Mamba2's short-conv
# weights start at zero (the reference's init), so x, v and the scan's
# output are zero and every gradient through the scan is exactly zero until
# a step with a nonzero lr has moved them: with 2 warmup steps step 0's lr
# is 0 and step 1's is not, so Zamba2's gate reads step 2.
SSM_GATE_STEP = {"rwkv6_7b": 0, "zamba2_1p2b": 2}
# Phase 16: gemma3_4b at full width and depth (34 layers, 8/4 heads of 320,
# window 1024, tied vocab 262144), B 8 x S 2048 from the structured stream
# in 8 microbatches of 1 (the fp32 logits of one are 2.15 GB; of all 8,
# 17.2 GB), on the in-place Trainer; seamless_m4t_medium at full width and
# depth (12 + 12 layers, 16 heads of 64), B 8 with 1024 seeded frames and
# 256 target tokens, through the in-place make_train_fn.
GEMMA_TRAIN = dict(B=8, S=2048, microbatch=8, steps=10)
SEAMLESS_TRAIN = dict(B=8, S_enc=1024, S=256, steps=10)
# The flash backward's route in phase 16: the tensor cores at D 64 and at
# gemma3_4b's D 320 (kernels/flash_attention/kernel.py bwd_route).
TRAIN16_BWD_ROUTE = {"gemma3_4b": "wgmma", "seamless_m4t_medium": "wgmma"}
# Phase 16's gradient gate (train_gate on one microbatch of the first
# batch): the wq/wk/wv/wo gradients of every attention layer (gemma3_4b's
# window, global and tail layers; SeamlessM4T's encoder, decoder self- and
# cross-attention) and the global norm, through the kernels against the
# plain attention path, the worst ||g - g_plain|| / ||g_plain||.  An H100
# measured 0.020815 (gemma3_4b) and 0.24296 (seamless_m4t_medium) at seed
# 0; these allow 3.5 times that.  SeamlessM4T's worst leaves are the
# decoder self-attention's wq and wk in layers 5-11, whose gradients are
# about a hundredth of the others' (|g| 4e-4 to 6e-4 against 2e-2 to 9e-2:
# near-uniform attention, where dS is a small difference and the kernel's
# bf16 P shows); its wv and wo read at most 0.034.  The planted faults read
# 12703 and 0.85786 (gemma3_4b), 248.60 and 1.1826 (seamless_m4t_medium).
TOL_TRAIN16_GRADS = {"gemma3_4b": 0.073, "seamless_m4t_medium": 0.85}


def log(msg: str) -> None:
    print(msg, flush=True)


def tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return tree


class Timer:
    """Device time of one call, median over launches, with the 50 MB L2
    evicted before each launch as the main path finds it (every layer
    reads other weights and another layer's cache in between).  After the
    flush the card spins for about 0.2 ms, so that the host has queued the
    call before the card reaches its start event: a kernel of a few
    microseconds is timed, not the host's work in its wrapper."""

    HOLD_CYCLES = 400_000       # about 0.2 ms at the H100's 1.98 GHz

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = H100_BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak_flops
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


def check_flash(gen, timer, seed) -> dict:
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention_xla

    bf16, fp32 = torch.bfloat16, torch.float32
    # B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, SDPA timed; the first is
    # TinyLlama's prefill shape (G = 8 query heads per K/V head), the fifth
    # Zamba2's shared attention block (G = 1), the sixth and seventh
    # granite-MoE's (G = 3) and DBRX's (G = 6, D 128), the last the first in
    # fp32, which takes the CUDA-core route.
    cases = [(8, 512, 512, 32, 4, 64, True, None, bf16, True),
             (8, 500, 500, 32, 4, 64, True, None, bf16, False),
             (8, 512, 512, 32, 4, 64, True, 128, bf16, False),
             (8, 128, 512, 32, 4, 64, False, None, bf16, True),
             (8, 512, 512, 32, 32, 64, True, None, bf16, True),
             (8, 512, 512, 24, 8, 64, True, None, bf16, False),
             (8, 512, 512, 48, 8, 128, True, None, bf16, False),
             (8, 512, 512, 32, 4, 64, True, None, fp32, False)]
    # SeamlessM4T's, gemma3_4b's and qwen2_vl_72b's calls (bf16, SDPA
    # timed) draw from generators of their own, so that the later phases
    # draw the same weights as before they were added.
    seamless = torch.Generator(device="cuda").manual_seed(seed)
    gemma = torch.Generator(device="cuda").manual_seed(seed)
    vlm = torch.Generator(device="cuda").manual_seed(seed)
    dense = torch.Generator(device="cuda").manual_seed(seed)
    cases = ([c + (gen, None) for c in cases]
             + [(B, Sq, Sk, Hq, Hkv, D, causal, None, bf16, True, seamless,
                 f"SeamlessM4T {use}")
                for B, Sq, Sk, Hq, Hkv, D, causal, use in FLASH_SEAMLESS]
             + [(B, Sq, Sk, Hq, Hkv, D, True, window, getattr(torch, dt), True,
                 gemma, f"gemma3_4b {use}")
                for B, Sq, Sk, Hq, Hkv, D, window, dt, use in FLASH_GEMMA]
             + [(VLM["B"], VLM["S"], VLM["S"], 64, 8, 128, True, None, bf16, True,
                 vlm, "qwen2_vl_72b prefill")]
             + [(B, Sq, Sk, Hq, Hkv, D, True, None, bf16, True, dense, use)
                for B, Sq, Sk, Hq, Hkv, D, use in FLASH_DENSE])
    tol = {bf16: TOL_BF16, fp32: TOL_FP32}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, calls = [], {}
    for B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, time_sdpa, g, use in cases:
        q = torch.randn(B, Sq, Hq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, q_offset=0 if causal else None)
        calls.setdefault(use, (q, k, v, kw))
        before = dict(flash_attention_cuda.launches_by_route)
        out = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        routed = [r for r, n in flash_attention_cuda.launches_by_route.items()
                  if n != before[r]]
        ref = flash_attention_xla(q, k, v, **kw)
        err = max_err(out, ref)
        want_route = "wgmma" if dtype == bf16 else "simt"
        ok = (bool(torch.isfinite(out.float()).all()) and err <= tol[dtype]
              and routed == [want_route])
        q_off = 0 if causal else Sk - Sq
        flops = 4 * D * B * Hq * flash_pairs(Sq, Sk, causal, window, q_off)
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        # fp32 stays exact only on CUDA cores, so its operations count at
        # the fp32 rate, not the tensor cores' bf16 rate.
        bnd, by = bound_ms(nbytes, flops,
                           H100_BF16_FLOPS if dtype == bf16 else H100_FP32_FLOPS)
        row = dict(case=(B, Sq, Sk, Hq, Hkv, D, causal, window, str(dtype)[6:]),
                   use=use, route=routed, err=err, ok=ok,
                   ms=timer.ms(lambda: flash_attention_cuda(q, k, v, **kw)),
                   plain_ms=timer.ms(lambda: flash_attention_xla(q, k, v, **kw),
                                     iters=5),
                   bound_ms=bnd, bound_by=by, library_ms=None)
        backend = ""
        if time_sdpa:  # the yardstick: one PyTorch call, never used by the port
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa_kw = dict(is_causal=causal, enable_gqa=True)
            if window is not None:  # the causal window as a boolean mask
                qpos = torch.arange(Sq, device="cuda")[:, None] + q_off
                kpos = torch.arange(Sk, device="cuda")[None, :]
                sdpa_kw = dict(attn_mask=(kpos <= qpos) & (kpos > qpos - window),
                               enable_gqa=True)
            row["library_ms"] = timer.ms(lambda: sdpa(qt, kt, vt, **sdpa_kw))
            row["sdpa_backend"] = SDPBackend(torch._fused_sdp_choice(
                qt, kt, vt, sdpa_kw.get("attn_mask"), 0.0,
                sdpa_kw.get("is_causal", False), enable_gqa=True)).name
            backend = f"; SDPA backend {row['sdpa_backend']}"
        log(f"flash {row['case']}{f' ({use})' * bool(use)} "
            f"route {routed}: max|err| {err:.3e} (tol "
            f"{tol[dtype]}) kernel {row['ms']:.4f} ms plain "
            f"{row['plain_ms']:.4f} ms library {row['library_ms']} ms bound "
            f"{bnd:.4f} ms ({by}){backend}")
        rows.append(row)
    for use in (None,) + tuple(c[-1] for c in FLASH_DENSE):
        q, k, v, kw = calls[use]
        case = next(r["case"] for r in rows if r["use"] == use)
        log(f"flash wrapper host time "
            f"{host_us(lambda: flash_attention_cuda(q, k, v, **kw)):.2f} us a call "
            f"at {case} (checks, route, ctypes call, tensor maps and "
            "launch; median of 5 x 200 calls)")
    if not all(r["ok"] for r in rows):
        raise SystemExit("flash_attention kernel disagrees with its plain "
                         "version or took the wrong route")
    by_use = {r["use"]: r for r in rows}
    return {"main": rows[0], "qwen2_vl_72b": by_use["qwen2_vl_72b prefill"],
            **{use.split()[0]: by_use[use] for *_, use in FLASH_DENSE}}


def sass_count(lib: Path, opcode: str, marker: str = "") -> int:
    """Instructions of ``opcode`` in the SASS of a built library, in the
    functions whose mangled name holds ``marker`` (all by default)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    functions = re.split(r"^\s*Function : ", sass, flags=re.M)[1:]
    return sum(len(re.findall(rf"\b{opcode}\.", f)) for f in functions
               if marker in f.split("\n", 1)[0])


def ptxas_lines(log: str, marker: str) -> list[str]:
    """The register and spill lines of ``ptxas -v`` for the entry functions
    whose mangled name holds ``marker``."""
    out, keep = [], False
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            keep = marker in entry.group(1)
        elif keep and ("spill" in line or "Used" in line):
            out.append(line.strip())
    return out


def check_bwd_sass(report: dict) -> None:
    """HGMMA in the SASS of the tensor-core flash backward's D 64, D 128 and
    D 320 instances, logged with ptxas's registers and spills of each (from
    ``report``, ``_build.build``'s, where this run built the library);
    raises at 0."""
    from repro_torch.kernels import _build

    lib = "flash_attention_bwd_wgmma"
    for marker, dim in (("Li64E", 64), ("Li128E", 128), ("Li320E", 320)):
        count = sass_count(_build.lib_path(lib), "HGMMA", marker)
        lines = (ptxas_lines(report[lib]["ptxas"], marker) if lib in report
                 else ["built before this run: no ptxas output"])
        log(f"SASS of {lib}, D {dim} instances: {count} HGMMA instructions; "
            "ptxas -v: " + "; ".join(lines))
        if count == 0:
            raise SystemExit(f"the tensor-core flash backward's D {dim} instances "
                             "have no tensor-core (HGMMA) instruction")
    if lib in report:
        warnings = [line.strip() for line in report[lib]["ptxas"].splitlines()
                    if "arning" in line or "Performance" in line]
        log(f"ptxas -v, {lib}: " + ("; ".join(warnings) or "no warnings"))
        # The D 320 dK/dV kernel's setmaxnreg budget (24 + 2 x 240 a thread of
        # its three warpgroups) assumes it launches with 168 registers; with
        # fewer its consumers would wait forever for registers.
        regs = ptxas_lines(report[lib]["ptxas"], "flash_bwd_wgmma_dkdv_split_kernel")
        if not any("Used 168 registers" in line for line in regs):
            raise SystemExit("the D 320 dK/dV kernel does not launch with the 168 "
                             f"registers its setmaxnreg budget assumes: {regs}")


def gla_bwd_ptxas(report: dict) -> None:
    """ptxas's registers and spills of the gla_scan backwards: the
    tensor-core library's two kernels, the CUDA-core library's bf16
    instance of each kernel at K = V = 64, and the most registers and the
    spill stores over all its instances."""
    lib = "gla_scan_bwd_mma"
    if lib in report:
        for label, marker in (("states", "gla_bwd_mma_states_kernel"),
                              ("gradients", "gla_bwd_mma_kernel")):
            log(f"ptxas -v, {lib} {label}: "
                + "; ".join(ptxas_lines(report[lib]["ptxas"], marker)))
    else:
        log(f"ptxas -v, {lib}: built before this run, no ptxas output")
    lib = "gla_scan_bwd"
    if lib not in report:
        log(f"ptxas -v, {lib}: built before this run, no ptxas output")
        return
    text = report[lib]["ptxas"]
    for label, marker in (
            ("scan, states", "gla_bwd_scan_kernelI13__nv_bfloat16Li64ELi64ELb0E"),
            ("scan, state gradients", "gla_bwd_scan_kernelI13__nv_bfloat16Li64ELi64ELb1E"),
            ("dqk", "gla_bwd_dqk_kernelI13__nv_bfloat16Li64E"),
            ("dv", "gla_bwd_dv_kernelI13__nv_bfloat16Li64ELi32E")):
        log(f"ptxas -v, {lib} {label} (bf16, K = V = 64): "
            + "; ".join(ptxas_lines(text, marker)))
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", text))
    log(f"ptxas -v, {lib}: {len(regs)} instances, at most {max(regs)} registers, "
        f"{spills} bytes of spill stores in all")


def timed_prefill(api, params, tokens, S, cache_len, kernels, want,
                  extra=None):
    """Warm up (the first call of each matmul shape pays one-time library
    set-up that a serving process pays once), set the ``kernels``' launch
    counts to 0, then time one prefill of ``tokens[:, :S]`` (and the batch
    entries ``extra``, such as frames) and hold the counts to ``want`` and
    the logits to their shape.  Returns (logits, cache, seconds, counts)."""
    cfg, dev = api.cfg, api.device
    batch = {"tokens": tokens[:, :S], **(extra or {})}
    _, warm = api.prefill(params, batch, cache_len=cache_len)
    api.decode_step(params, warm, S, tokens[:, S:S + 1])
    del warm
    for fn in kernels.values():
        fn.launches = 0
        for r in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[r] = 0
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch, cache_len=cache_len)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    if counts != want:
        raise SystemExit(f"{cfg.name} prefill launched {counts}, want {want}")
    for name, fn in kernels.items():
        if name in PREFILL_ROUTES:
            # bf16 prefill: every launch on the kernel's tensor-core route
            routes = dict(fn.launches_by_route)
            if routes != {r: want[name] * (r == PREFILL_ROUTES[name]) for r in routes}:
                raise SystemExit(f"{cfg.name} prefill {name} routes {routes}")
            counts[f"{name} routes"] = routes
    if (tuple(logits.shape) != (tokens.shape[0], cfg.padded_vocab)
            or not torch.isfinite(logits.float()).all()):
        raise SystemExit(f"prefill logits {tuple(logits.shape)} not finite")
    return logits, cache, seconds, counts


def near_tie(ref, got) -> tuple[float, int, int, float]:
    """(max |err|, greedy tokens equal, tokens, largest gap): a greedy
    token may differ only where the reference logits of the two candidates
    are a near-tie, so the gap is the reference's between them."""
    tr, tg = ref.argmax(-1, keepdim=True), got.argmax(-1, keepdim=True)
    gap = (ref.gather(-1, tr) - ref.gather(-1, tg)).abs().max().item()
    return max_err(ref, got), int((tr == tg).sum().item()), tr.numel(), gap


def paged_inputs(gen, B, Hq, Hkv, D, page, max_len, min_len):
    """bf16 q and pools of B * max_len / page pages under a shuffled block
    table, and seq_lens drawn from [min_len, max_len] with
    seq_lens[0] = max_len."""
    maxp = max_len // page
    P = B * maxp
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").bfloat16()
    kp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").bfloat16()
    table = torch.randperm(P, generator=gen, device="cuda").int().view(B, maxp)
    seq_lens = torch.randint(min_len, max_len + 1, (B,), generator=gen,
                             device="cuda", dtype=torch.int32)
    seq_lens[0] = max_len
    return q, kp, vp, table, seq_lens


def paged_simt(q, kp, vp, table, seq_lens):
    """The CUDA-core paged kernel (the simt route, the only one before the
    split route) launched through its C entry point on a call the rule
    sends to the split route, for timing beside it in the same run."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as K

    lib, symbol = K._LIBS["simt"]
    out = torch.empty_like(q)
    B, Hq, D = q.shape
    code = _build.function(lib, symbol, K._ARGTYPES)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, Hq, kp.shape[2], D,
        kp.shape[1], table.shape[1], D ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    return out


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` (microseconds, median of 5 runs of
    ``calls`` calls): what a wrapper costs the host before its kernel is
    queued, which the Timer's device times leave out."""
    fn()
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def check_paged(gen, timer, seed) -> dict:
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    # At page 128: TinyLlama's heads (G = 8, D 64) at the decode shape of
    # earlier PRs (contexts up to 1024), granite-MoE's (G = 3, D 64) and
    # DBRX's (G = 6, D 128) at the same shape, then TinyLlama's at a long
    # context (16384-32768 positions: 256 table columns, two pools of 2048
    # pages, 134 MB each), where the bytes bound and not the launch latency
    # is the yardstick.  qwen2_vl_72b's (G = 8, D 128) at phase 13's cache of
    # 2304 positions draws from a generator of its own, so that the later
    # cases and phases draw the same numbers as before it was added.
    # qwen2p5_14b's (G = 5) and starcoder2_7b's (G = 9), both D 128, at
    # phases 19-20's cache of 1024 positions, draw from another, and beside
    # them SDPA (enable_gqa) is timed on the same K/V laid out dense, with
    # each sequence's length as a key mask: a yardstick, since it does not
    # page.
    B, page = 8, 128
    vlm = torch.Generator(device="cuda").manual_seed(seed)
    dense = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, calls = [], {}
    for label, Hq, Hkv, D, max_len, min_len, tol, g in (
            ("decode", 32, 4, 64, 1024, 1, TOL_BF16, gen),
            ("granite-MoE decode", 24, 8, 64, 1024, 1, TOL_BF16, gen),
            ("DBRX decode", 48, 8, 128, 1024, 1, TOL_BF16, gen),
            ("qwen2_vl_72b decode", 64, 8, 128, VLM["cache_len"], 1, TOL_BF16,
             vlm),
            ("long context", 32, 4, 64, 32768, 16384, TOL_PAGED_LONG, gen),
            *((label, Hq, Hkv, D, 1024, 1, TOL_BF16, dense)
              for label, Hq, Hkv, D in PAGED_DENSE)):
        q, kp, vp, table, seq_lens = paged_inputs(g, B, Hq, Hkv, D, page,
                                                  max_len, min_len)
        args = (q, kp, vp, table, seq_lens)
        calls[label] = args
        before = dict(paged_attention_cuda.launches_by_route)
        out = paged_attention_cuda(*args)
        torch.cuda.synchronize()
        routed = [r for r, n in paged_attention_cuda.launches_by_route.items()
                  if n != before[r]]
        ref = paged_attention_ref(*args)
        err = max_err(out, ref)
        simt_err = max_err(paged_simt(*args), ref)
        n_rows = int(seq_lens.sum().item())
        nbytes = (2 * n_rows * Hkv * D * 2 + 2 * 2 * q.numel()
                  + 4 * (table.numel() + B))
        bnd, by = bound_ms(nbytes, 4 * n_rows * Hq * D)
        row = dict(case=(label, B, Hq, Hkv, D, page, max_len), route=routed,
                   err=err, ms=timer.ms(lambda: paged_attention_cuda(*args)),
                   plain_ms=timer.ms(lambda: paged_attention_ref(*args), iters=5),
                   bound_ms=bnd, bound_by=by, library_ms=None,
                   ok=(bool(torch.isfinite(out.float()).all())
                       and err <= tol and simt_err <= tol
                       and routed == ["split"]))
        simt_ms = timer.ms(lambda: paged_simt(*args))
        yardstick = ""
        if g is dense:
            kd, vd = (pool[table.long()].flatten(1, 2).transpose(1, 2).contiguous()
                      for pool in (kp, vp))          # (B, Hkv, max_len, D)
            mask = (torch.arange(max_len, device="cuda")[None]
                    < seq_lens[:, None])[:, None, None]
            qd = q[:, :, None]
            row["sdpa_dense_ms"] = timer.ms(lambda: sdpa(qd, kd, vd, attn_mask=mask,
                                                         enable_gqa=True))
            yardstick = (f", SDPA over the same K/V laid out dense (enable_gqa, "
                         f"a length mask; no paging) {row['sdpa_dense_ms']:.4f} ms")
        ref_abs = ref.float().abs()
        log(f"paged {label}: B {B} Hq {Hq} Hkv {Hkv} D {D} page {page} "
            f"seq_lens {seq_lens.tolist()} route {routed}: max|err| {err:.3e} "
            f"(tol {tol}; |ref| mean {ref_abs.mean().item():.3e} max "
            f"{ref_abs.max().item():.3e}) kernel {row['ms']:.4f} ms, CUDA-core "
            f"kernel (simt route) {simt_ms:.4f} ms (max|err| {simt_err:.3e}), "
            f"plain {row['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB){yardstick}; no single PyTorch call pages")
        rows.append(row)
    for label in ("long context",) + tuple(c[0] for c in PAGED_DENSE):
        args = calls[label]
        log(f"paged wrapper host time {host_us(lambda: paged_attention_cuda(*args)):.2f} "
            f"us a call at {label} (checks, route, ctypes call and launch; median "
            "of 5 x 200 calls)")
    if not all(r["ok"] for r in rows):
        raise SystemExit("paged_attention kernel disagrees with its plain "
                         "version or took the wrong route")
    by_label = {r["case"][0]: r for r in rows}
    return {"main": rows[0], "qwen2_vl_72b": rows[3],
            **{label.split()[0]: by_label[label] for label, *_ in PAGED_DENSE}}


def check_decode(timer, seed) -> dict:
    """The dense decode attention kernel against its plain body at
    ``DECODE_DENSE``'s shapes, bf16 and fp32, at valid 1, 17, one short of
    the cache and the full cache (each launch on the split route); one CUDA
    graph a shape captured at the full cache and replayed at 17 and one
    short of it, bit-equal to eager calls; in bf16 at the timed length the
    kernel's, the plain body's and SDPA's times (SDPA over the live
    positions laid out (B, H, n, D): the yardstick; the port never calls
    it), the bound, and the dispatcher's host time a call."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for label, B, S, Hq, Hkv, D, n_time in DECODE_DENSE:
        base = [torch.randn(*shape, generator=g, device="cuda")
                for shape in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
        worst = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            errs = []
            for n in sorted({1, 17, S - 1, S}):
                tol = (TOL_FP32 if dtype == torch.float32 else
                       TOL_PAGED_LONG if n >= LONG_DECODE else TOL_BF16)
                valid = torch.tensor(n, dtype=torch.int32, device="cuda")
                before = decode_attention_cuda.launches_by_route["split"]
                out = decode_attention(q, k, v, valid)
                torch.cuda.synchronize()
                routed = decode_attention_cuda.launches_by_route["split"] - before
                errs.append(max_err(out, decode_attention_ref(q, k, v, valid)))
                if routed != 1 or not torch.isfinite(out.float()).all() or errs[-1] > tol:
                    raise SystemExit(f"decode attention {label} {dtype} valid {n}: "
                                     f"max|err| {errs[-1]:.3e} (tol {tol}), "
                                     f"{routed} split launches")
            worst[dtype] = max(errs)
            valid = torch.tensor(S, dtype=torch.int32, device="cuda")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = decode_attention(q, k, v, valid)
            for n in (17, S - 1):
                valid.fill_(n)
                graph.replay()
                want = decode_attention(q, k, v, torch.tensor(n, dtype=torch.int32,
                                                              device="cuda"))
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"decode attention {label} {dtype}: a replay "
                                     f"at valid {n} differs from the eager call")
            del graph
        q, k, v = (t.bfloat16() for t in base)
        n = n_time
        valid = torch.tensor(n, dtype=torch.int32, device="cuda")
        nbytes = 2 * B * n * Hkv * D * 2 + 2 * 2 * q.numel() + 4
        bnd, by = bound_ms(nbytes, 4 * B * Hq * D * n)
        qs, ks, vs = (t[:, :n].transpose(1, 2).contiguous() for t in (q, k, v))
        row = dict(case=(label, B, S, Hq, Hkv, D, n), route=["split"],
                   err=worst[torch.bfloat16],
                   ms=timer.ms(lambda: decode_attention(q, k, v, valid)),
                   plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, valid),
                                     iters=5),
                   library_ms=timer.ms(lambda: sdpa(qs, ks, vs, enable_gqa=True)),
                   bound_ms=bnd, bound_by=by)
        host = host_us(lambda: decode_attention(q, k, v, valid))
        log(f"decode attention {label}: B {B} S_cache {S} Hq {Hq} Hkv {Hkv} D {D}, "
            f"valid 1/17/{S - 1}/{S}: max|err| bf16 {worst[torch.bfloat16]:.3e} "
            f"(tol {TOL_BF16}, {TOL_PAGED_LONG} from {LONG_DECODE} positions), "
            f"fp32 {worst[torch.float32]:.3e} (tol {TOL_FP32}), "
            f"every launch on split; a graph captured at {S} replayed at 17 and "
            f"{S - 1} bit-equal to eager, both dtypes; at valid {n} (bf16) kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA over the "
            f"live positions {row['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB); dispatcher host time {host:.2f} us a call")
        rows[label.split()[0]] = row
    return rows


def gla_work(q, v, w, chunk: int) -> tuple[int, int]:
    """(bytes, flops) one gla_scan call must move and do: q, k, v, o and
    the final state once each, w as its strides lay it out (a stride-0 K
    axis is read once per position), and the chunked form's products over
    the causal pairs of each chunk plus the state's two K x V products."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    w_elems = B * H * S * (K if w.stride(-1) else 1)
    nbytes = (q.element_size() * (2 * q.numel() + 2 * v.numel())
              + 4 * w_elems + 4 * B * H * K * V)
    flops = 0
    for c0 in range(0, S, C):
        n = min(C, S - c0)
        flops += 2 * (n * (n + 1) // 2) * (K + V) + 4 * n * K * V
    return nbytes, B * H * flops


def check_gla(gen, timer) -> dict:
    from repro_torch.kernels.ssm_scan.kernel import gla_scan_cuda
    from repro_torch.kernels.ssm_scan.ops import gla_scan_xla

    bf16, fp32 = torch.bfloat16, torch.float32
    # B, H, S, K, V, dtype, decay, chunk, route.  The first is RWKV6's
    # prefill shape and the third Zamba2's (one decay per head); chunk 120
    # is not a multiple of 16, so that bf16 call takes the CUDA-core route.
    cases = [(8, 64, 512, 64, 64, bf16, "rwkv6", 128, "mma"),
             (8, 64, 500, 64, 64, bf16, "rwkv6", 128, "mma"),
             (8, 64, 512, 64, 64, bf16, "mamba2", 128, "mma"),
             (8, 64, 512, 64, 64, bf16, "strong", 128, "mma"),   # w = -2.5
             (8, 64, 512, 64, 64, bf16, "rwkv6", 120, "simt"),
             (8, 64, 512, 64, 64, fp32, "rwkv6", 128, "simt"),
             (8, 64, 512, 64, 64, fp32, "strong", 128, "simt")]
    rows, first = [], None
    for B, H, S, K, V, dtype, decay, chunk, want_route in cases:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        q, k = (randn(B, H, S, K) * 0.5).to(dtype), (randn(B, H, S, K) * 0.5).to(dtype)
        v = randn(B, H, S, V).to(dtype)
        if decay == "mamba2":
            w = (-0.05 * torch.exp(randn(B, H, S, 1))).expand(B, H, S, K)
        elif decay == "strong":
            w = torch.full((B, H, S, K), -2.5, device="cuda")
        else:
            w = -0.05 * torch.exp(randn(B, H, S, K))
        first = first or (q, k, v, w, chunk)
        before = dict(gla_scan_cuda.launches_by_route)
        o, st = gla_scan_cuda(q, k, v, w, chunk)
        torch.cuda.synchronize()
        routed = [r for r, n in gla_scan_cuda.launches_by_route.items()
                  if n != before[r]]
        ro, rs = gla_scan_xla(q, k, v, w, chunk)
        tol = TOL_GLA[dtype]
        ok = (bool(torch.isfinite(o.float()).all() and torch.isfinite(st).all())
              and torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
              and torch.allclose(st, rs, atol=TOL_GLA_STATE, rtol=TOL_GLA_STATE)
              and routed == [want_route])
        err, s_err = max_err(o, ro), max_err(st, rs)
        # fp32 stays exact only on CUDA cores, so its operations count at
        # the fp32 rate, not the tensor cores' bf16 rate.
        bnd, by = bound_ms(*gla_work(q, v, w, chunk),
                           H100_BF16_FLOPS if dtype == bf16 else H100_FP32_FLOPS)
        row = dict(case=(B, H, S, K, V, str(dtype)[6:], decay, chunk),
                   route=routed, err=err, ok=ok,
                   ms=timer.ms(lambda: gla_scan_cuda(q, k, v, w, chunk)),
                   plain_ms=timer.ms(lambda: gla_scan_xla(q, k, v, w, chunk), iters=5),
                   bound_ms=bnd, bound_by=by, library_ms=None)
        extra = "" if rows else (f"; CUDA-core kernel before the tensor-core "
                                 f"route {GLA_SIMT_BEFORE_MS} ms")
        log(f"gla_scan {row['case']} route {routed}: max|err| o {err:.3e} "
            f"(atol=rtol {tol:g}, largest |o| {ro.float().abs().max().item():.1f}) "
            f"state {s_err:.3e} ({TOL_GLA_STATE:g}); kernel {row['ms']:.4f} ms "
            f"plain {row['plain_ms']:.4f} ms bound {bnd:.4f} ms ({by}){extra}; "
            "no single PyTorch call computes a gated linear-attention scan")
        rows.append(row)
    log(f"gla_scan wrapper host time "
        f"{host_us(lambda: gla_scan_cuda(*first)):.2f} us a call at "
        f"{rows[0]['case']} (checks, route, outputs, ctypes call and launch; "
        "median of 5 x 200 calls)")
    if not all(r["ok"] for r in rows):
        raise SystemExit("gla_scan kernel disagrees with its plain version "
                         "or took the wrong route")
    return rows[0]


def gla_bwd_work(q, v, w, chunk: int, with_final: bool) -> tuple[int, int]:
    """(bytes, flops) one gla_scan backward call must move and do: q, k, v,
    dO (and the final state's gradient) read and dq, dk, dv and dw written
    once each, w as its strides lay it out, and the chunked form's
    products: P, dP and the three intra-chunk gradients over the causal
    pairs of each chunk, and five K x V products a row (dO S^T, v dS^T,
    (k~ e) dS, q~^T dO and the state's k~^T v)."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    w_elems = B * H * S * (K if w.stride(-1) else 1)
    nbytes = (q.element_size() * (4 * q.numel() + 3 * v.numel())
              + 4 * w_elems + 4 * q.numel() + 4 * B * H * K * V * with_final)
    flops = 0
    for c0 in range(0, S, C):
        n = min(C, S - c0)
        flops += 2 * (n * (n + 1) // 2) * (3 * K + 2 * V) + 10 * n * K * V
    return nbytes, B * H * flops


def gla_bwd_simt(q, k, v, w, do, d_final, chunk: int = 128):
    """The CUDA-core gla_scan backward (the simt route, the only one before
    the mma route) launched through its C entry point on a call the rule
    sends to the mma route, for timing beside it in the same run."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import kernel as K

    lib, symbol, argtypes = K._BWD_LIBS["simt"]
    B, H, S, Kd = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    states = torch.empty((B, H, -(-S // C), Kd, V), dtype=torch.float32, device=q.device)
    dstates = torch.empty_like(states)
    strides = [s for t in (q, k, v, w, do) for s in t.stride()]
    code = _build.function(lib, symbol, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), do.data_ptr(),
        None if d_final is None else d_final.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), states.data_ptr(), dstates.data_ptr(), B, H, S,
        Kd, V, C, *strides, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    return dq, dk, dv, dw


def check_gla_bwd(timer, seed) -> dict:
    """The gla_scan backward kernel against ``gla_scan_bwd_ref`` at
    ``GLA_BWD``'s shapes, from a generator of its own: the route the rule
    names asserted, the error beside its tolerance (and dw's alone), two
    calls bit-equal, kernel, plain and bound times (the bound's two parts
    named), and on the mma rows the CUDA-core kernel's time and error
    beside them.  No single PyTorch call computes the scan's gradient, so
    there is no library time.  Returns the rows by use."""
    from repro_torch.kernels.ssm_scan.kernel import bwd_route, gla_scan_bwd_cuda
    from repro_torch.kernels.ssm_scan.ref import gla_scan_bwd_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for B, H, S, K, V, dt, decay, with_final, want, use in GLA_BWD:
        dtype = getattr(torch, dt)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")
        q, k = (randn(B, H, S, K) * 0.5).to(dtype), (randn(B, H, S, K) * 0.5).to(dtype)
        v, do = randn(B, H, S, V).to(dtype), randn(B, H, S, V).to(dtype)
        if decay == "mamba2":
            w = (-0.05 * torch.exp(randn(B, H, S, 1))).expand(B, H, S, K)
        elif decay == "strong":
            w = torch.full((B, H, S, K), -2.5, device="cuda")
        else:
            w = -0.05 * torch.exp(randn(B, H, S, K))
        d_final = randn(B, H, K, V) if with_final else None
        route = bwd_route(q, k, v, w, do, 128)
        before = dict(gla_scan_bwd_cuda.launches_by_route)
        got = gla_scan_bwd_cuda(q, k, v, w, do, d_final, 128)
        again = gla_scan_bwd_cuda(q, k, v, w, do, d_final, 128)
        torch.cuda.synchronize()
        routed = route == want and {r: c - before[r] for r, c in
                                    gla_scan_bwd_cuda.launches_by_route.items()} == {
                                        r: 2 * (r == route) for r in before}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = gla_scan_bwd_ref(q, k, v, w, do, d_final, 128)
        err = bwd_err(got, ref)
        dw_err = bwd_err(got[3:], ref[3:])
        abs_err = max(max_err(a, b) for a, b in zip(got, ref))
        largest = max(r.float().abs().max().item() for r in ref)
        simt_err = (bwd_err(gla_bwd_simt(q, k, v, w, do, d_final), ref)
                    if route == "mma" else None)
        del ref, again
        tol = TOL_GLA_BWD[dt]
        ok = routed and same and err <= tol and all(
            bool(torch.isfinite(t.float()).all()) for t in got)
        del got
        nbytes, flops = gla_bwd_work(q, v, w, 128, with_final)
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
        bnd, by = bound_ms(nbytes, flops, peak)
        row = dict(case=(B, H, S, K, V, dt, decay, 128), use=use, err=err,
                   abs_err=abs_err, ok=ok, route=[route],
                   ms=timer.ms(lambda: gla_scan_bwd_cuda(q, k, v, w, do, d_final, 128),
                               iters=10),
                   simt_ms=(timer.ms(lambda: gla_bwd_simt(q, k, v, w, do, d_final), iters=10)
                            if route == "mma" else None),
                   plain_ms=timer.ms(lambda: gla_scan_bwd_ref(q, k, v, w, do, d_final, 128),
                                     iters=3, warmup=1),
                   bound_ms=bnd, bound_by=by, library_ms=None)
        simt = ("" if simt_err is None else
                f"; the CUDA-core kernel {row['simt_ms']:.4f} ms, max|err| {simt_err:.3e}")
        log(f"gla_scan backward {row['case']} ({use}): route {route}"
            f"{'' if routed else ' NOT THE RULE OR NOT TAKEN'}; max|err| {err:.3e} of max "
            f"|grad| (tol {tol}; dw {dw_err:.3e}; {abs_err:.3e} absolute, largest |grad| "
            f"{largest:.4g}), two calls {'bit-equal' if same else 'DIFFER'}; kernel "
            f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound {bnd:.4f} ms ({by}: "
            f"{nbytes / 1e9:.4f} GB at 3.35 TB/s {nbytes / H100_BYTES_PER_S * 1e3:.4f} ms, "
            f"{flops / 1e9:.3f} GFLOP at the "
            f"{'bf16 tensor-core' if peak == H100_BF16_FLOPS else 'fp32'} rate "
            f"{flops / peak * 1e3:.4f} ms, at the fp32 rate "
            f"{flops / H100_FP32_FLOPS * 1e3:.4f} ms; kernel {row['ms'] / bnd:.1f}x the "
            f"bound){simt}; no single PyTorch call computes the scan's gradient")
        rows[use] = row
        del q, k, v, w, do, d_final
        torch.cuda.empty_cache()
    if not all(r["ok"] for r in rows.values()):
        raise SystemExit("gla_scan backward kernel disagrees with its plain version, "
                         "gives non-finite gradients, differs between two calls "
                         "or took another route than the rule's")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width.
# ---------------------------------------------------------------------------


def bwd_err(got, ref) -> float:
    """The flash backward's error: the worst over dq, dk and dv of max
    |err| over the reference gradient's largest |value| (the gradients'
    scale varies with the shape and the output gradient)."""
    return max(max_err(g, r) / max(r.float().abs().max().item(), 1e-30)
               for g, r in zip(got, ref))


def tile_err(got, ref, tile: int = 64) -> tuple[float, str]:
    """The per-tile gate of phase 3's D 320 rows: the worst over the 64-key
    tiles of dK and dV and the 64-column blocks of dQ of max |err| over
    that piece's own largest |value|, with the piece.  The D 320 backward
    splits its work over key tiles, two warpgroups (dV, dK) and 64-column
    blocks; a piece it dropped whose gradient is small (the last key tile
    of a causal call, seen by the last 64 queries alone) passes a gate over
    the whole tensor's largest |gradient|, not this one."""
    dq, dk, dv = got
    rq, rk, rv = ref
    pieces = {}
    for name, g, r in (("dK", dk, rk), ("dV", dv, rv)):
        for t0 in range(0, g.shape[1], tile):
            pieces[f"{name} keys {t0}+"] = (g[:, t0:t0 + tile], r[:, t0:t0 + tile])
    for c0 in range(0, dq.shape[-1], tile):
        pieces[f"dQ columns {c0}+"] = (dq[..., c0:c0 + tile], rq[..., c0:c0 + tile])
    errs = {name: max_err(g, r) / max(r.float().abs().max().item(), 1e-30)
            for name, (g, r) in pieces.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def tile_faults() -> dict:
    """Planted faults of the per-tile gate, applied to the kernel's (dq, dk,
    dv): each drops one piece of the D 320 backward's split."""
    def columns_zeroed(dq, dk, dv):
        dk = dk.clone()
        dk[..., -64:] = 0
        return dq, dk, dv

    name = "the last key tile's dK/dV zeroed"
    return {name: bwd_faults()[name], "dK's last 64 columns zeroed": columns_zeroed}


def flash_bwd_simt(q, k, v, o, do, *, causal, window, q_offset):
    """The CUDA-core flash backward (the simt route, the only one before the
    wgmma route) launched through its C entry point on a call the rule
    sends to the wgmma route, for timing beside it in the same run."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K

    lib, symbol, argtypes = K._BWD_LIBS["simt"]
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    code = _build.function(lib, symbol, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D, int(causal),
        window or 0, int(q_offset), D ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    return dq, dk, dv


def check_flash_bwd(timer, seed) -> dict:
    """The flash backward kernel against ``attention_bwd_ref`` at
    ``FLASH_BWD``'s shapes, from a generator of its own: the route the rule
    names asserted, the error beside its tolerance, two calls bit-equal,
    kernel, plain and SDPA-backward times and the bound; on the wgmma route
    the lse comes from the forward, as in training, and the CUDA-core
    kernel is timed beside it; at D 320 also the per-tile gate
    (``tile_err``), which ``tile_faults`` must fail.  Returns the rows by
    use."""
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attention.kernel import (
        bwd_route, flash_attention_bwd_cuda, flash_attention_fwd_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, dt, use in FLASH_BWD:
        dtype = getattr(torch, dt)
        q = torch.randn(B, Sq, Hq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        do = torch.randn(B, Sq, Hq, D, generator=g, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        route = bwd_route(dtype, D)
        with torch.no_grad():
            o, lse = flash_attention_fwd_cuda(q, k, v, with_lse=route == "wgmma", **kw)
        bkw = dict(kw, lse=lse) if lse is not None else kw
        before = dict(flash_attention_bwd_cuda.launches_by_route)
        got = flash_attention_bwd_cuda(q, k, v, o, do, **bkw)
        again = flash_attention_bwd_cuda(q, k, v, o, do, **bkw)
        torch.cuda.synchronize()
        routed = {r: c - before[r] for r, c in
                  flash_attention_bwd_cuda.launches_by_route.items()} == {
                      r: 2 * (r == route) for r in before}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = attention_bwd_ref(q, k, v, o, do, **kw)
        err = bwd_err(got, ref)
        abs_err = max(max_err(g, r) for g, r in zip(got, ref))
        simt_err = (bwd_err(flash_bwd_simt(q, k, v, o, do, **kw), ref)
                    if route == "wgmma" else None)
        tol = TOL_BWD[dt]
        tiles = ""
        tiles_ok = True
        if D == 320:
            tiles_err, piece = tile_err(got, ref)
            faults = {name: (tile_err(fault(*got), ref), bwd_err(fault(*got), ref))
                      for name, fault in tile_faults().items()}
            tiles_ok = tiles_err <= tol and all(r > tol for (r, _), _ in faults.values())
            tiles = (f"; per tile {tiles_err:.3e} at {piece} (tol {tol}); planted faults: "
                     + "; ".join(f"{name} {r:.3e} at {at} ({'fails' if r > tol else 'PASSES'}"
                                 f" the per-tile gate; {whole:.3e} over the whole tensor)"
                                 for name, ((r, at), whole) in faults.items()))
        del ref
        ok = routed and same and err <= tol and tiles_ok and all(
            bool(torch.isfinite(t.float()).all()) for t in got)
        del got, again
        flops = 2.5 * 4 * D * B * Hq * flash_pairs(Sq, Sk, causal, window, q_off)
        nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
        bnd, by = bound_ms(nbytes, flops,
                           H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS)
        row = dict(case=(B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, dt), use=use,
                   err=err, abs_err=abs_err, ok=ok, route=[route],
                   ms=timer.ms(lambda: flash_attention_bwd_cuda(q, k, v, o, do, **bkw),
                               iters=10),
                   simt_ms=(timer.ms(lambda: flash_bwd_simt(q, k, v, o, do, **kw), iters=10)
                            if route == "wgmma" else None),
                   plain_ms=timer.ms(lambda: attention_bwd_ref(q, k, v, o, do, **kw),
                                     iters=3, warmup=1),
                   bound_ms=bnd, bound_by=by, library_ms=None)
        backend = ""
        if dtype == torch.bfloat16:  # the yardstick, never used by the port
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            skw = dict(is_causal=causal, enable_gqa=True)
            if window is not None or q_off != 0:   # the masks as a boolean mask
                qpos = torch.arange(Sq, device="cuda")[:, None] + q_off
                kpos = torch.arange(Sk, device="cuda")[None, :]
                mask = kpos <= qpos
                if window is not None:
                    mask &= kpos > qpos - window
                skw = dict(attn_mask=mask, enable_gqa=True)
            out = sdpa(qt, kt, vt, **skw)
            row["library_ms"] = timer.ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), iters=10)
            row["sdpa_backend"] = SDPBackend(torch._fused_sdp_choice(
                qt, kt, vt, skw.get("attn_mask"), 0.0, skw.get("is_causal", False),
                enable_gqa=True)).name
            backend = f"; SDPA backward, backend {row['sdpa_backend']}"
            del qt, kt, vt, out
        simt = ("" if simt_err is None else
                f"; the CUDA-core kernel {row['simt_ms']:.4f} ms, max|err| {simt_err:.3e}")
        log(f"flash backward {row['case']} ({use}): route {route}"
            f"{'' if routed else ' NOT TAKEN'}; max|err| {err:.3e} of max "
            f"|grad| (tol {tol}; {abs_err:.3e} absolute), two calls {'bit-equal' if same else 'DIFFER'}; "
            f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
            f"{row['library_ms']} ms bound {bnd:.4f} ms ({by}: 2.5x the "
            f"forward's operations){backend}{simt}{tiles}")
        rows[use] = row
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    if not all(r["ok"] for r in rows.values()):
        raise SystemExit("flash backward kernel disagrees with its plain version "
                         "(at D 320 also per tile, or a planted fault passes that "
                         "gate), gives non-finite gradients, differs between two "
                         "calls or took another route than the rule's")
    return rows


def reduced_train_launches(cfg) -> tuple[int, int, int, int]:
    """(flash forward, flash backward, gla_scan forward, gla_scan backward)
    launches of one value_and_grad: a rematerialized layer runs its forward
    kernel twice (Zamba2's tail is not rematerialized); an encoder-decoder
    layer pair has three attention calls (encoder self-attention, decoder
    self- and cross-attention)."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        n = cfg.encoder_layers + 2 * cfg.decoder_layers
        return 2 * n, n, 0, 0
    if cfg.family == "ssm":
        return 0, 0, 2 * L, L
    if cfg.family == "hybrid":
        groups = L // cfg.attn_every
        return 2 * groups, groups, 2 * groups * cfg.attn_every + L % cfg.attn_every, L
    return 2 * L, L, 0, 0


def check_reduced_grads_against_cpu(arch: str, seed: int) -> None:
    """A reduced ``arch`` in fp32 (2 layers; zamba2_1p2b: 5 Mamba2 layers,
    two groups of 2 and a tail of 1, with seeded short-conv weights;
    seamless_m4t_medium: 2 encoder and 2 decoder layers over 24 seeded
    frames; gemma3_4b: ``REDUCED_CHANGES``, a window the 24 tokens cross;
    qwen2_vl_72b: a seeded bf16 embeds prefix of min(VLM_PATCH_TOKENS,
    S // 4) rows): ``loss_fn``'s value and every
    gradient leaf on the card (the flash and gla_scan forwards, twice a
    rematerialized layer, and their backward kernels once a layer) against
    the CPU path (their plain versions), each leaf's max |err| over its
    largest |value|."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.ssm_scan.kernel import gla_scan_bwd_cuda, gla_scan_cuda
    from repro_torch.models.registry import VLM_PATCH_TOKENS, build_model
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import leaf_paths

    cfg = reduced_config(get_config(arch))
    if cfg.family not in ("hybrid", "encdec"):
        cfg = dataclasses.replace(cfg, **REDUCED_CHANGES.get(arch, dict(num_layers=2)))
    params, _ = build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    if cfg.family == "hybrid":
        # Mamba2's short-conv weights start at zero, which zeroes the scan's
        # x, v and output and every gradient through it but dv's: seeded
        # ones make the scan live
        g = torch.Generator().manual_seed(seed + 1)
        for part in ("groups", "tail"):
            conv = params[part]["mamba"]["conv"]
            conv.copy_(0.3 * torch.randn(conv.shape, generator=g))
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 24),
                        generator=torch.Generator().manual_seed(seed))
    batch = {"tokens": tok[0], "labels": tok[1]}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 24, cfg.d_model,
                                      generator=torch.Generator().manual_seed(seed + 1))
    if cfg.family == "vlm":
        batch["embeds"] = (0.02 * torch.randn(
            2, min(VLM_PATCH_TOKENS, 24 // 4), cfg.d_model,
            generator=torch.Generator().manual_seed(seed + 2))).to(torch.bfloat16)
    counters = (flash_attention_cuda, flash_attention_bwd_cuda, gla_scan_cuda,
                gla_scan_bwd_cuda)
    out = {}
    for dev in ("cpu", "cuda"):
        before = [fn.launches for fn in counters]
        loss, g = value_and_grad(build_model(cfg, dev), tree_to(params, dev, torch.float32),
                                 {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (loss.float().cpu(), [t.float().cpu() for _, t in leaf_paths(g)])
        launches = tuple(fn.launches - b for fn, b in zip(counters, before))
    if launches != reduced_train_launches(cfg):
        raise SystemExit(f"reduced {arch} gradients on the card launched "
                         f"{launches} flash forwards and backwards and gla_scan "
                         "forwards and backwards")
    worst = max([abs(out["cpu"][0] - out["cuda"][0]).item() / abs(out["cpu"][0]).item()]
                + [max_err(a, b) / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(out["cuda"][1], out["cpu"][1])])
    depth = (f"L{cfg.encoder_layers}+{cfg.decoder_layers}" if cfg.family == "encdec"
             else f"L{cfg.num_layers}")
    log(f"reduced {arch} ({depth}), card vs CPU path (fp32, loss_fn and its "
        f"{len(out['cpu'][1])} gradient leaves; {launches[0]} forward and "
        f"{launches[1]} backward flash launches, {launches[2]} forward and "
        f"{launches[3]} backward gla_scan launches): max|err| {worst:.3e} of "
        f"max |value| (tol {TOL_FP32})")
    if worst > TOL_FP32:
        raise SystemExit(f"reduced {arch} gradients on the card disagree with "
                         "the CPU path")


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


def check_reduced_against_cpu(arch: str, seed: int) -> None:
    """A 2-layer reduced ``arch`` in fp32: the card (both kernels) against
    the CPU path (their plain versions) on the same weights and tokens,
    prefill and 4 paged steps.  For the MoE family also the forward's
    summed load-balance loss; for granite-MoE also the first layer's MoE at
    capacity factor 0.5 (tokens drop): its output, ``aux_loss`` and
    ``dropped_frac``; for the vlm family (M-RoPE) a seeded embeds prefix of
    8 rows in the prefill and the forward, whose logits are compared too.
    (The reduced DBRX has granite's E, K and widths, so the same draws
    would give it the same MoE layer.)"""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    cfg = dataclasses.replace(reduced_config(get_config(arch)), num_layers=2)
    params, _ = TF.init_lm(cfg, torch.Generator().manual_seed(seed), "cpu")
    cpu_p = tree_to(params, "cpu", torch.float32)
    gpu_p = tree_to(params, "cuda", torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (2, 20),
                        generator=torch.Generator().manual_seed(seed))
    moe_x = torch.randn(2, 20, cfg.d_model,
                        generator=torch.Generator().manual_seed(seed + 1))
    embeds = None
    if cfg.family == "vlm":
        embeds = 0.02 * torch.randn(2, 8, cfg.d_model,
                                    generator=torch.Generator().manual_seed(seed + 2))
    worst = 0.0
    outs, moe = {}, {}
    for dev, p in (("cpu", cpu_p), ("cuda", gpu_p)):
        t = tok.to(dev)
        e = None if embeds is None else embeds.to(dev)
        logits, cache = TF.lm_prefill(p, cfg, t[:, :16], cache_len=20, embeds=e)
        paged = TF.lm_init_paged_cache(cfg, 2, 20, page=4,
                                       dtype=torch.float32, device=dev)
        fill_paged_pool(cache, paged, torch.arange(10, device=dev).flip(0))
        seq = [logits]
        for s in range(16, 20):
            seq.append(TF.lm_decode_step_paged(p, cfg, paged, s,
                                               t[:, s:s + 1])[0])
        if cfg.family == "moe":
            moe[dev] = {"forward aux": TF.lm_forward(p, cfg, t)[1]}
        if e is not None:
            seq.append(TF.lm_forward(p, cfg, t, embeds=e)[0])
        if arch == MOE_ARCHS[0]:
            out, aux = MOE.moe_fwd(
                {k: v[0] for k, v in p["blocks"]["moe"].items()}, moe_x.to(dev),
                num_experts=cfg.num_experts, top_k=cfg.top_k, kind=cfg.mlp,
                capacity_factor=0.5)
            moe[dev] |= {"aux_loss": aux["aux_loss"],
                         "dropped_frac": aux["dropped_frac"]}
            seq.append(out)
        outs[dev] = [x.float().cpu() for x in seq + list(moe.get(dev, {}).values())]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        worst = max(worst, max_err(a, b))
    what = "prefill + 4 paged steps"
    if embeds is not None:
        what = "prefill with an embeds prefix + 4 paged steps, forward with it"
    if moe:
        what += "; " + ", ".join(f"{k} {v.item():.4f}"
                                 for k, v in moe["cuda"].items())
    if arch == MOE_ARCHS[0]:
        what += ", the last two of layer 0's MoE at capacity factor 0.5"
    log(f"reduced {arch}, card vs CPU path (fp32, {what}): max|err| "
        f"{worst:.3e} (tol {TOL_FP32})")
    if worst > TOL_FP32 or moe.get("cuda", {}).get("dropped_frac", 1) == 0:
        raise SystemExit(f"reduced {arch} on the card disagrees with the CPU "
                         "path (or its MoE check dropped no token)")


def check_reduced_api_against_cpu(arch: str, seed: int) -> None:
    """A reduced ``arch`` (rwkv6_7b: 4 layers; zamba2_1p2b: 5 Mamba2 layers
    and a shared attention block every 2; seamless_m4t_medium: 2 encoder
    and 2 decoder layers over 24 frames; gemma3_4b: ``REDUCED_CHANGES``)
    in fp32: the card (gla_scan and flash kernels) against the CPU path
    (their plain versions) on the same weights and inputs, through the
    registry's forward, prefill and 4 decode steps."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              **REDUCED_CHANGES.get(arch, {}))
    params, _ = build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    tok = torch.randint(0, cfg.vocab_size, (2, 20),
                        generator=torch.Generator().manual_seed(seed))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.randn(
            2, 24, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1))
    outs = {}
    for dev in ("cpu", "cuda"):
        api, p, t = build_model(cfg, dev), tree_to(params, dev, torch.float32), tok.to(dev)
        batch = {k: v.to(dev) for k, v in extra.items()}
        logits, state = api.prefill(p, {"tokens": t[:, :16], **batch}, cache_len=20)
        seq = [api.forward(p, {"tokens": t, **batch})[0], logits]
        for i in range(16, 20):
            logits, state = api.decode_step(p, state, i, t[:, i:i + 1])
            seq.append(logits)
        outs[dev] = [x.float().cpu() for x in seq]
    worst = max(max_err(a, b) for a, b in zip(outs["cpu"], outs["cuda"]))
    log(f"reduced {arch}, card vs CPU path (fp32, forward, prefill + 4 decode steps): "
        f"max|err| {worst:.3e} (tol {TOL_FP32})")
    if worst > TOL_FP32:
        raise SystemExit(f"reduced {arch} on the card disagrees with the CPU path")


def graph_decode(label, step, params, state0, tokens, t0, eager_logits):
    """Capture ``step`` in a DecodeGraph on a clone of ``state0`` and replay
    the steps from ``t0`` that gave ``eager_logits``, twice (the second
    time timed, from ``state0`` copied back into the captured buffers):
    every replayed logit must equal the eager one bit for bit, since the
    same kernels run in the same order on the same inputs.  Returns the
    graph, its state, ms a step, the first call's seconds (warm-up,
    capture and one replay) and the paged launches that call counted by
    route (replays count none, which is checked)."""
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda as paged_cuda)
    from repro_torch.serve.engine import DecodeGraph, tree_clone, tree_leaves

    dev, n = tokens.device, len(eager_logits)
    static = tree_clone(state0)
    g = DecodeGraph(step, params, static)
    routes0 = dict(paged_cuda.launches_by_route)
    worst, ms = 0.0, None
    for rnd in range(2):
        for dst, src in zip(tree_leaves(static), tree_leaves(state0)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        sync(dev)
        t_start = time.perf_counter()
        got = []
        for i, t in enumerate(range(t0, t0 + n)):
            lg, _ = g(params, static, t, tokens[:, t:t + 1])
            got.append(lg.float())
            if rnd == 0 and i == 0:
                sync(dev)
                first_s = time.perf_counter() - t_start
                captured = {r: c - routes0[r]
                            for r, c in paged_cuda.launches_by_route.items()}
        sync(dev)
        if rnd == 1:
            ms = (time.perf_counter() - t_start) / n * 1e3
        worst = max(worst, max(max_err(a, b) for a, b in zip(got, eager_logits)))
        if not all(torch.equal(a, b) for a, b in zip(got, eager_logits)):
            raise SystemExit(f"{label}: replayed logits differ from the eager "
                             f"ones (max|err| {worst:.3e})")
    after = {r: c - routes0[r] for r, c in paged_cuda.launches_by_route.items()}
    if after != captured:
        raise SystemExit(f"{label}: replays counted paged launches {after}, "
                         f"{captured} at capture")
    return g, static, ms, first_s, captured


def main_path(api, params, gen, flash_cuda, paged_cuda, B=8, S=512,
              cache_len=1024, steps=8, page=128, extra=None,
              step_bound=None) -> dict:
    """Prefill B x S (with the batch entries ``extra``, such as an embeds
    prefix), dense and paged decode eager and captured, paged held against
    dense, profiles beside ``step_bound`` (``(ms, what)`` of a decode step;
    the weights read once by default).  Returns the launch counts, the
    paged cache after the eager steps, the tokens and the eager dense
    logits."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda as decode_cuda)
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import DecodeGraph, tree_clone

    cfg, dev = api.cfg, api.device
    extra = extra or {}
    tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                           device=dev)
    with torch.inference_mode():
        prefill_lg, cache, prefill_s, prefill_counts = timed_prefill(
            api, params, tokens, S, cache_len,
            {"flash_attention": flash_cuda, "paged_attention": paged_cuda,
             "decode_attention": decode_cuda},
            {"flash_attention": cfg.num_layers, "paged_attention": 0,
             "decode_attention": 0}, extra)
        paged = TF.lm_init_paged_cache(cfg, B, cache_len, page=page,
                                       device=dev)
        perm = torch.randperm(B * cache_len // page, generator=gen, device=dev)
        fill_paged_pool(cache, paged, perm)
        cache0, paged0 = tree_clone(cache), tree_clone(paged)

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
    # every dense step's attention on the dense kernel (the card's models
    # all have head dims of 64 or 128 and at most 9 query heads a kv head)
    counts = {"flash_attention": flash_cuda.launches,
              "paged_attention": paged_cuda.launches,
              "decode_attention": decode_cuda.launches}
    if counts != {"flash_attention": cfg.num_layers,
                  "paged_attention": cfg.num_layers * steps,
                  "decode_attention": cfg.num_layers * steps * (dev.type == "cuda")}:
        raise SystemExit(f"main path launches {counts}")
    paged_routes = dict(paged_cuda.launches_by_route)
    if paged_routes != {r: counts["paged_attention"] * (r == "split")
                        for r in paged_routes}:
        raise SystemExit(f"paged decode routes {paged_routes}, want every "
                         "launch on the split route")
    p = torch.stack(paged_logits)
    err, same, n_tok, gap = near_tie(torch.stack(dense_logits), p)
    log(f"main path {cfg.name} L{cfg.num_layers} d{cfg.d_model}: prefill "
        f"{B}x{S} {prefill_s * 1e3:.3f} ms, dense decode {dense_s * 1e3:.3f} "
        f"ms/step, paged decode {paged_s * 1e3:.3f} ms/step, launches {counts}, "
        f"prefill flash routes {prefill_counts['flash_attention routes']}, "
        f"paged decode routes {paged_routes}")
    tol = TOL_PAGED_LOGITS[cfg.name]
    log(f"paged vs dense decode logits over {steps} steps: max|err| {err:.4f} "
        f"(tol {tol}); greedy tokens equal {same}/{n_tok}, "
        f"largest dense-logit gap where they differ {gap:.4f}")
    if cfg.family == "moe":
        r = moe_routing(api, params, cache0, paged0, tokens, S, steps)
        if not torch.equal(r["dense_logits"], torch.stack(dense_logits)):
            raise SystemExit(f"{cfg.name}: dense decode rerun from the same "
                             "cache gave other logits")
        pin = TOL_PAGED_PINNED[cfg.name]
        log(f"{cfg.name} pinned limit {pin}: the run must be within it, the "
            "planted fault outside it")
        if not (r["finite"] and max(r["pinned"][0], r["pinned"][3]) <= pin
                < r["fault"][0]):
            raise SystemExit(f"{cfg.name}: paged decode with pinned experts "
                             "disagrees with dense decode, or the planted "
                             "fault passes the pinned limit")
    if not (torch.isfinite(p).all() and err <= tol and gap <= tol):
        raise SystemExit("paged decode disagrees with dense decode")
    flash0 = flash_cuda.launches

    def paged_step(p_, c_, n_, t_):
        return TF.lm_decode_step_paged(p_, cfg, c_, n_, t_)

    dense0 = decode_cuda.launches
    with torch.inference_mode():
        g_dense, cache_g, dense_g_ms, dense_first, dense_captured = graph_decode(
            "dense decode graph", api.decode_step, params, cache0, tokens, S,
            dense_logits)
        dense_graph = decode_cuda.launches - dense0
        g_paged, paged_g, paged_g_ms, paged_first, captured = graph_decode(
            "paged decode graph", paged_step, params, paged0, tokens, S,
            paged_logits)
    want = cfg.num_layers * (DecodeGraph.WARMUP + 1)
    if (captured != {r: want * (r == "split") for r in captured}
            or flash_cuda.launches != flash0):
        raise SystemExit(f"paged decode graph: first call launched paged "
                         f"{captured}, want {want} on split; flash "
                         f"{flash_cuda.launches - flash0}, want 0")
    # the dense graph's first call: warm-up and capture, replays none (more
    # would show here); the paged graph and every paged launch none
    if (dense_graph != want * (dev.type == "cuda")
            or decode_cuda.launches != dense0 + dense_graph
            or any(dense_captured.values())):
        raise SystemExit(f"dense decode graph: decode attention launches "
                         f"{dense_graph} at its first call (want {want}), "
                         f"{decode_cuda.launches - dense0 - dense_graph} in the "
                         f"paged graph (want 0), paged {dense_captured} (want none)")
    log(f"decode graphs {cfg.name} B {B}, {steps} steps from position {S}: "
        f"dense eager {dense_s * 1e3:.3f} ms/step, graph {dense_g_ms:.3f} "
        f"ms/step (first call {dense_first * 1e3:.1f} ms: {DecodeGraph.WARMUP} "
        f"warm-up steps on clones, capture, replay); paged eager "
        f"{paged_s * 1e3:.3f} ms/step, graph {paged_g_ms:.3f} ms/step (first "
        f"call {paged_first * 1e3:.1f} ms); replayed logits equal to the eager "
        f"ones bit for bit, twice over; paged launches counted at the first "
        f"call {captured} ({cfg.num_layers} captured, the rest warm-up), none "
        f"on replays; dense decode attention launches at the dense graph's "
        f"first call {dense_graph} on split ({cfg.num_layers} captured, the "
        "rest warm-up), none on replays or in the paged graph")
    if dev.type == "cuda":
        bound = step_bound or (weights_ms(params), "weights read once")
        with torch.inference_mode():
            for label, step in (
                    (f"{cfg.name} prefill", lambda t: api.prefill(
                        params, {"tokens": tokens[:, :S], **extra},
                        cache_len=cache_len)),
                    (f"{cfg.name} dense decode", lambda t: api.decode_step(
                        params, cache, t, tokens[:, t:t + 1])),
                    (f"{cfg.name} paged decode", lambda t: TF.lm_decode_step_paged(
                        params, cfg, paged, t, tokens[:, t:t + 1])),
                    (f"{cfg.name} dense decode graph", lambda t: g_dense(
                        params, cache_g, t, tokens[:, t:t + 1])),
                    (f"{cfg.name} paged decode graph", lambda t: g_paged(
                        params, paged_g, t, tokens[:, t:t + 1]))):
                profile_steps(label, step, S + steps - 2, 2,
                              *((None,) if label.endswith("prefill") else bound))
    return {"counts": counts, "paged": paged, "tokens": tokens,
            "dense_logits": torch.stack(dense_logits),
            "prefill_logits": prefill_lg.float(), "dense_graph_ms": dense_g_ms}


def first_page_dropped(paged_attention):
    """The planted paged fault of phases 9-10 and 19-20: ``paged_attention``
    called without the first page of every sequence (the pages one cluster
    rank holds)."""
    def faulted(q, k_pool, v_pool, table, seq_lens):
        return paged_attention(q, k_pool, v_pool, table[:, 1:].contiguous(),
                               seq_lens - k_pool.shape[1])
    return faulted


def moe_routing(api, params, cache0, paged0, tokens, S, steps) -> dict:
    """Run the dense and the paged decode steps again from the post-prefill
    caches, recording every layer's top-K experts (``moe.route``, which
    ``moe_fwd`` calls), and log how many tokens' expert sets differ between
    the two paths in each layer.  Then run the paged steps twice more with
    each layer's experts pinned to the dense path's (gates from the paged
    path's own probs): once as they are, so that what is left of the
    paged-vs-dense difference is the attention paths' rounding carried
    through the layers, and once with a planted fault, the paged kernel
    called without the first page of every sequence (the pages one
    cluster rank holds).  Returns the dense rerun's logits, the flips per
    layer, ``near_tie`` of the pinned run and of the faulted one, and the
    mean |logit| of the dense path."""
    from unittest import mock

    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import tree_clone

    cfg = api.cfg
    route = MOE.route

    def run(step, state, pinned=None):
        rec, logits = [], []

        def recording(p_, x, top_k):
            probs, vals, idx = route(p_, x, top_k)
            if pinned is not None:
                idx = pinned[len(rec)]
                vals = probs.gather(-1, idx)
                vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
            rec.append(idx)
            return probs, vals, idx

        with mock.patch.object(MOE, "route", recording), torch.inference_mode():
            for t in range(S, S + steps):
                lg, state = step(params, state, t, tokens[:, t:t + 1])
                logits.append(lg.float())
        return rec, torch.stack(logits)

    def paged_step(p_, c_, n_, t_):
        return TF.lm_decode_step_paged(p_, cfg, c_, n_, t_)

    def sets(rec):
        return torch.stack(rec).sort(dim=-1).values.view(
            steps, cfg.num_layers, -1, cfg.top_k)

    dense_rec, dense_lg = run(api.decode_step, tree_clone(cache0))
    paged_rec, _ = run(paged_step, tree_clone(paged0))
    _, pinned_lg = run(paged_step, tree_clone(paged0), pinned=dense_rec)
    with mock.patch.object(TF, "paged_attention",
                           first_page_dropped(TF.paged_attention)):
        _, fault_lg = run(paged_step, tree_clone(paged0), pinned=dense_rec)
    per_layer = (sets(dense_rec) != sets(paged_rec)).any(-1).sum(dim=(0, 2)).tolist()
    r = {"dense_logits": dense_lg, "flips": per_layer,
         "pinned": near_tie(dense_lg, pinned_lg),
         "fault": near_tie(dense_lg, fault_lg),
         "finite": bool(torch.isfinite(pinned_lg).all()),
         "logit_abs": dense_lg.abs().mean().item()}
    log(f"{cfg.name} routing, paged vs dense decode: top-{cfg.top_k} expert "
        f"sets differ for {sum(per_layer)} of {steps * cfg.num_layers * tokens.shape[0]} "
        f"(step, token, layer) triples; per layer {per_layer}")
    for what in ("pinned", "fault"):
        err, same, n_tok, gap = r[what]
        log(f"{cfg.name} paged vs dense decode, experts pinned to the dense "
            f"path's{', first page dropped (planted fault)' * (what == 'fault')}: "
            f"max|err| {err:.4f} (mean |logit| {r['logit_abs']:.4f}); greedy "
            f"tokens equal {same}/{n_tok}, largest dense-logit gap where they "
            f"differ {gap:.4f}")
    return r


def ssm_path(api, params, gen, gla_cuda, flash_cuda, B=8, S=512,
             cache_len=1024, steps=8) -> dict:
    """Prefill B x S through the kernels, then ``steps`` decode steps, each
    held against the last logits of a prefill of the prompt it has seen
    (prefill(S) + n steps == prefill(S + n)): the kernel's final state
    carried on by the recurrence."""
    from repro_torch.serve.engine import tree_clone

    cfg, dev = api.cfg, api.device
    n_groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    want = {"gla_scan": cfg.num_layers, "flash_attention": n_groups}
    tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                           device=dev)

    def prefill(n):
        return api.prefill(params, {"tokens": tokens[:, :n]}, cache_len=cache_len)

    with torch.inference_mode():
        _, state, prefill_s, counts = timed_prefill(
            api, params, tokens, S, cache_len,
            {"gla_scan": gla_cuda, "flash_attention": flash_cuda}, want)
        state0 = tree_clone(state)
        decoded = []
        sync(dev)
        t0 = time.perf_counter()
        for t in range(S, S + steps):
            lg, state = api.decode_step(params, state, t, tokens[:, t:t + 1])
            decoded.append(lg.float())
        sync(dev)
        decode_s = (time.perf_counter() - t0) / steps
        if gla_cuda.launches != want["gla_scan"]:
            raise SystemExit("decode launched the gla_scan kernel")
        g, state_g, graph_ms, first_s, _ = graph_decode(
            f"{cfg.name} decode graph", api.decode_step, params, state0,
            tokens, S, decoded)
        if (gla_cuda.launches, flash_cuda.launches) != (want["gla_scan"],
                                                        want["flash_attention"]):
            raise SystemExit(f"{cfg.name} decode graph launched a prefill kernel")
        full = [prefill(S + n)[0].float() for n in range(1, steps + 1)]
    d = torch.stack(decoded)
    err, same, n_tok, gap = near_tie(torch.stack(full), d)
    tol = TOL_CONT_LOGITS[cfg.name]
    log(f"{cfg.name} L{cfg.num_layers} d{cfg.d_model}: prefill {B}x{S} "
        f"{prefill_s * 1e3:.3f} ms, decode eager {decode_s * 1e3:.3f} ms/step, "
        f"graph {graph_ms:.3f} ms/step (first call {first_s * 1e3:.1f} ms: "
        f"warm-up on clones, capture, replay; the new state copied into the "
        f"captured buffers; replayed logits equal to the eager ones bit for "
        f"bit, twice over), prefill launches {counts}")
    log(f"{cfg.name} prefill({S}) + n decode steps vs prefill({S}+n), n = 1.."
        f"{steps}: max|err| {err:.4f} (tol {tol}); greedy tokens equal "
        f"{same}/{n_tok}, largest prefill-logit gap where they differ "
        f"{gap:.4f}")
    if not (torch.isfinite(d).all() and err <= tol and gap <= tol):
        raise SystemExit(f"{cfg.name} decode does not continue its prefill")
    if dev.type == "cuda":
        with torch.inference_mode():
            profile_steps(f"{cfg.name} prefill", lambda t: prefill(S), 0, 2)
            profile_steps(f"{cfg.name} decode", lambda t: api.decode_step(
                params, state, t, tokens[:, t:t + 1]), S + steps - 2, 2,
                weights_ms(params))
            profile_steps(f"{cfg.name} decode graph", lambda t: g(
                params, state_g, t, tokens[:, t:t + 1]), S + steps - 2, 2,
                weights_ms(params))
    return counts


def seamless_inputs(cfg, gen, B, S_enc, n):
    """Seeded normal frames (B, S_enc, d_model) and n decoder tokens, on
    the generator's device."""
    frames = torch.randn(B, S_enc, cfg.d_model, generator=gen, device=gen.device)
    tokens = torch.randint(0, cfg.vocab_size, (B, n), generator=gen,
                           device=gen.device)
    return frames, tokens


def roll_cross(cache) -> None:
    """The planted fault of phase 11, in place: every sequence's cross K/V
    swapped for its neighbour's (rolled one along the batch axis), so each
    attends to another source."""
    for name in ("cross_k", "cross_v"):
        cache[name].copy_(cache[name].roll(1, dims=1))


def decode_logits(step, params, state, tokens, S, steps) -> torch.Tensor:
    """Float logits of ``steps`` decode steps of ``step`` from ``state``."""
    out = []
    for t in range(S, S + steps):
        lg, state = step(params, state, t, tokens[:, t:t + 1])
        out.append(lg.float())
    return torch.stack(out)


def prefill_logits(api, params, extra, tokens, S, steps, cache_len):
    """Last logits of prefill(S + n) over the same batch entries ``extra``
    (frames, embeds), n = 1..steps."""
    return torch.stack([
        api.prefill(params, {"tokens": tokens[:, :S + n], **extra},
                    cache_len=cache_len)[0].float()
        for n in range(1, steps + 1)])


def seamless_step_bound(params, cache) -> tuple[float, str]:
    """A lower bound on an encdec decode step in ms, and what it counts: the
    decoder's and the unembedding's weights, the cross K/V and the self K/V
    cache, each read once (the embedding reads B rows, left out)."""
    from repro_torch.serve.engine import tree_leaves

    def gb(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9

    parts = {"decoder + unembedding weights": gb(
                 [params["decoder"], params["embedding"]["unembed"],
                  params["final_norm"]]),
             "cross K/V": gb([cache["cross_k"], cache["cross_v"]]),
             "self K/V": gb([cache["k"], cache["v"]])}
    ms = {k: v * 1e9 / H100_BYTES_PER_S * 1e3 for k, v in parts.items()}
    what = " + ".join(f"{k} {parts[k]:.3f} GB ({ms[k]:.3f} ms)" for k in parts)
    return sum(ms.values()), f"bound ({what}) read once"


def seamless_path(api, params, gen, flash_cuda, B, S_enc, S, steps) -> None:
    """seamless_m4t_medium: encode B x S_enc frames and prefill an S-token
    prompt (every flash launch on wgmma: encoder, decoder self-attention,
    cross-attention), ``steps`` decode steps eager and from a DecodeGraph
    (bit-equal; flash once a layer at Sq 1), each held against the last
    logits of prefill(S + n) over the same frames, then the captured steps
    again with the cross K/V rolled one sequence (the planted fault, which
    must fail that limit), and profiles."""
    from repro_torch.serve.engine import DecodeGraph, tree_clone, tree_leaves

    cfg, dev = api.cfg, api.device
    Ld = cfg.decoder_layers
    cache_len = S + steps + 1
    frames, tokens = seamless_inputs(cfg, gen, B, S_enc, S + steps)
    want = {"flash_attention": cfg.encoder_layers + 2 * Ld}
    with torch.inference_mode():
        _, cache, prefill_s, counts = timed_prefill(
            api, params, tokens, S, cache_len, {"flash_attention": flash_cuda},
            want, extra={"frames": frames})
        state0 = tree_clone(cache)
        before = dict(flash_cuda.launches_by_route)
        sync(dev)
        t0 = time.perf_counter()
        decoded = decode_logits(api.decode_step, params, cache, tokens, S, steps)
        sync(dev)
        decode_s = (time.perf_counter() - t0) / steps
        routes = {r: n - before[r] for r, n in flash_cuda.launches_by_route.items()}
        if routes != {r: Ld * steps * (r == "wgmma") for r in routes}:
            raise SystemExit(f"{cfg.name} decode flash launches {routes}, want "
                             f"{Ld} a step on wgmma")
        before = dict(flash_cuda.launches_by_route)
        g, state_g, graph_ms, first_s, _ = graph_decode(
            f"{cfg.name} decode graph", api.decode_step, params, state0, tokens,
            S, list(decoded))
        captured = {r: n - before[r] for r, n in flash_cuda.launches_by_route.items()}
        n_cap = Ld * (DecodeGraph.WARMUP + 1)
        if captured != {r: n_cap * (r == "wgmma") for r in captured}:
            raise SystemExit(f"{cfg.name} decode graph: flash launches {captured}, "
                             f"want {n_cap} on wgmma at the first call, none on "
                             "replays")
        full = prefill_logits(api, params, {"frames": frames}, tokens, S, steps,
                              cache_len)
        for dst, src in zip(tree_leaves(state_g), tree_leaves(state0)):
            dst.copy_(src)
        roll_cross(state_g)
        faulted = decode_logits(g, params, state_g, tokens, S, steps)
    cont, fault = near_tie(full, decoded), near_tie(full, faulted)
    tol = TOL_CONT_LOGITS[cfg.name]
    log(f"{cfg.name} enc L{cfg.encoder_layers} dec L{Ld} d{cfg.d_model}: encode "
        f"{B}x{S_enc} frames + prefill {B}x{S} {prefill_s * 1e3:.3f} ms, decode "
        f"eager {decode_s * 1e3:.3f} ms/step, graph {graph_ms:.3f} ms/step "
        f"(first call {first_s * 1e3:.1f} ms; replayed logits equal to the "
        f"eager ones bit for bit, twice over), prefill launches {counts}, "
        f"decode flash launches {Ld} a step (Sq 1), {n_cap} at the graph's "
        "first call, none on replays")
    for what, (err, same, n_tok, gap) in (("", cont), (
            ", cross K/V rolled one sequence (planted fault)", fault)):
        log(f"{cfg.name} prefill({S}) + n decode steps vs prefill({S}+n), n = "
            f"1..{steps}{what}: max|err| {err:.4f} (limit {tol}; mean |logit| "
            f"{full.abs().mean().item():.4f}, largest {full.abs().max().item():.4f}); "
            f"greedy tokens equal {same}/{n_tok}, largest prefill-logit gap "
            f"where they differ {gap:.4f}")
    if not (torch.isfinite(decoded).all() and cont[0] <= tol and cont[3] <= tol):
        raise SystemExit(f"{cfg.name} decode does not continue its prefill")
    if fault[0] <= tol:
        raise SystemExit(f"{cfg.name}: the planted fault passes the limit {tol}")
    if dev.type == "cuda":
        bound, what = seamless_step_bound(params, cache)
        with torch.inference_mode():
            profile_steps(f"{cfg.name} prefill", lambda t: api.prefill(
                params, {"tokens": tokens[:, :S], "frames": frames},
                cache_len=cache_len), 0, 2)
            profile_steps(f"{cfg.name} decode", lambda t: api.decode_step(
                params, cache, t, tokens[:, t:t + 1]), S + steps - 2, 2,
                bound, what)
            profile_steps(f"{cfg.name} decode graph", lambda t: g(
                params, state_g, t, tokens[:, t:t + 1]), S + steps - 2, 2,
                bound, what)


def ring_fault(cache) -> None:
    """The planted fault of phase 12, in place: the first local layer's
    ring rolled by one slot, so that each position sits in the slot of the
    next one and the decode steps overwrite the newest position where the
    oldest should leave the window."""
    for name in ("local_k", "local_v"):
        cache[name][0, 0] = cache[name][0, 0].roll(1, dims=1)


def ring_readings(api, params, cache, tokens, S, steps, cache_len,
                  step=None) -> dict:
    """The continuation test of phase 12 on a post-prefill(S) ``cache``:
    ``steps`` decode steps of ``step`` (``api.decode_step`` by default)
    against the last logits of prefill(S + n), n = 1..steps (``near_tie``),
    and the cache the steps leave (every ring slot and global position)
    against the cache of prefill(S + steps): max |err| per cache tensor.
    A ring slot that holds another position than the reference's differs
    by a whole key, where rounding moves it by a few bf16 steps."""
    step = step or api.decode_step
    decoded = decode_logits(step, params, cache, tokens, S, steps)
    full = torch.stack([
        api.prefill(params, {"tokens": tokens[:, :S + n]}, cache_len=cache_len)[0].float()
        for n in range(1, steps + 1)])
    _, ref_cache = api.prefill(params, {"tokens": tokens[:, :S + steps]},
                               cache_len=cache_len)
    return {"logits": near_tie(full, decoded),
            "cache": {k: max_err(ref_cache[k], cache[k]) for k in ref_cache},
            "decoded": decoded, "logit_abs": full.abs().mean().item(),
            "logit_max": full.abs().max().item()}


def gemma3_step_bound(params, cfg, B, cache_len, kv_len) -> tuple[float, str]:
    """A lower bound on a local_global decode step in ms, and what it
    counts: the weights, the window layers' rings and the global layers'
    first ``kv_len + 1`` positions, each read once."""
    from repro_torch.serve.engine import tree_leaves

    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    n_global = cfg.num_layers // cfg.group_size
    row = B * 2 * 2 * cfg.num_kv_heads * cfg.hd   # K and V of one position, bf16
    parts = {"weights": weights,
             "rings": (cfg.num_layers - n_global) * min(cfg.window, cache_len) * row,
             "global K/V": n_global * (kv_len + 1) * row}
    ms = {k: v / H100_BYTES_PER_S * 1e3 for k, v in parts.items()}
    what = " + ".join(f"{k} {parts[k] / 1e9:.3f} GB ({ms[k]:.3f} ms)" for k in parts)
    return sum(ms.values()), f"bound ({what}) read once"


def gemma3_path(api, params, gen, flash_cuda, B, S, cache_len, steps) -> None:
    """gemma3_4b: prefill B x S (every flash launch on wgmma at D 320: the
    window layers' with the window, the global layers' without), ``steps``
    decode steps eager and from a DecodeGraph (bit-equal; no flash), held
    by ``ring_readings`` to prefill(S + n)'s logits and prefill(S +
    steps)'s cache, then the captured steps again from a ring rolled one
    slot (the planted fault, which must fail that test), profiles."""
    from unittest import mock

    from repro_torch.models import layers as L
    from repro_torch.serve.engine import tree_clone, tree_leaves

    cfg, dev = api.cfg, api.device
    n_global = cfg.num_layers // cfg.group_size
    tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                           device=dev)
    windows, flash = [], L.flash_attention

    def recording(q, k, v, **kw):
        windows.append(kw["window"])
        return flash(q, k, v, **kw)

    with torch.inference_mode():
        with mock.patch.object(L, "flash_attention", recording):
            _, cache, prefill_s, counts = timed_prefill(
                api, params, tokens, S, cache_len,
                {"flash_attention": flash_cuda},
                {"flash_attention": cfg.num_layers})
        timed = windows[-cfg.num_layers:]     # the timed prefill's calls
        by_window = {w: timed.count(w) for w in set(timed)}
        if by_window != {cfg.window: cfg.num_layers - n_global, None: n_global}:
            raise SystemExit(f"{cfg.name} prefill flash windows {by_window}")
        state0 = tree_clone(cache)
        sync(dev)
        t0 = time.perf_counter()
        cont = ring_readings(api, params, cache, tokens, S, steps, cache_len)
        sync(dev)
        cont_s = time.perf_counter() - t0
        if flash_cuda.launches != cfg.num_layers + (steps + 1) * cfg.num_layers:
            raise SystemExit(f"{cfg.name}: flash launches {flash_cuda.launches}, "
                             "want none in the decode steps")
        flash0 = flash_cuda.launches
        g, state_g, graph_ms, first_s, _ = graph_decode(
            f"{cfg.name} decode graph", api.decode_step, params, state0, tokens,
            S, list(cont["decoded"]))
        if flash_cuda.launches != flash0:
            raise SystemExit(f"{cfg.name} decode graph launched flash")
        for dst, src in zip(tree_leaves(state_g), tree_leaves(state0)):
            dst.copy_(src)
        ring_fault(state_g)
        fault = ring_readings(api, params, state_g, tokens, S, steps, cache_len,
                              step=g)
        sync(dev)
        t0 = time.perf_counter()
        decode_logits(api.decode_step, params, tree_clone(state0), tokens, S, steps)
        sync(dev)
        decode_s = (time.perf_counter() - t0) / steps
    log(f"{cfg.name} L{cfg.num_layers} ({cfg.num_layers - n_global} window "
        f"{cfg.window}, {n_global} global) d{cfg.d_model} hd{cfg.hd}: prefill "
        f"{B}x{S} into {cache_len} {prefill_s * 1e3:.3f} ms, decode eager "
        f"{decode_s * 1e3:.3f} ms/step, graph {graph_ms:.3f} ms/step (first "
        f"call {first_s * 1e3:.1f} ms; replayed logits equal to the eager ones "
        f"bit for bit, twice over), prefill launches {counts}, flash windows "
        f"{by_window}; continuation run {cont_s:.1f} s")
    tol, tol_cache = TOL_CONT_LOGITS[cfg.name], TOL_CONT_CACHE[cfg.name]
    for what, r in (("", cont), (", first local ring rolled one slot "
                                 "(planted fault)", fault)):
        err, same, n_tok, gap = r["logits"]
        log(f"{cfg.name} prefill({S}) + n decode steps vs prefill({S}+n), n = "
            f"1..{steps}{what}: max|err| {err:.4f} (limit {tol}; mean |logit| "
            f"{r['logit_abs']:.4f}, largest {r['logit_max']:.4f}); greedy "
            f"tokens equal {same}/{n_tok}, largest prefill-logit gap where "
            f"they differ {gap:.4f}; cache vs prefill({S}+{steps})'s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["cache"].items())
            + f" (limit {tol_cache})")
    err, _, _, gap = cont["logits"]
    if not (torch.isfinite(cont["decoded"]).all() and err <= tol and gap <= tol
            and max(cont["cache"].values()) <= tol_cache):
        raise SystemExit(f"{cfg.name} decode does not continue its prefill")
    if fault["logits"][0] <= tol and max(fault["cache"].values()) <= tol_cache:
        raise SystemExit(f"{cfg.name}: the planted ring fault passes the "
                         "continuation test")
    if dev.type == "cuda":
        bound, what = gemma3_step_bound(params, cfg, B, cache_len, S + steps - 1)
        with torch.inference_mode():
            profile_steps(f"{cfg.name} prefill", lambda t: api.prefill(
                params, {"tokens": tokens[:, :S]}, cache_len=cache_len), 0, 2)
            profile_steps(f"{cfg.name} decode", lambda t: api.decode_step(
                params, cache, t, tokens[:, t:t + 1]), S + steps - 2, 2,
                bound, what)
            profile_steps(f"{cfg.name} decode graph", lambda t: g(
                params, state_g, t, tokens[:, t:t + 1]), S + steps - 2, 2,
                bound, what)


def vlm_embeds(cfg, gen, B, S) -> torch.Tensor:
    """A bf16 embeds prefix (B, V, d_model) drawn N(0, 0.02) from ``gen``
    (on its device), V = min(VLM_PATCH_TOKENS, S // 4): the reference's
    patch rows for a prompt of S positions (stub vision frontend)."""
    from repro_torch.models.registry import VLM_PATCH_TOKENS

    V = min(VLM_PATCH_TOKENS, S // 4)
    return (0.02 * torch.randn(B, V, cfg.d_model, generator=gen,
                               device=gen.device)).bfloat16()


def kv_step_bound(params, cfg, B, kv_len) -> tuple[float, str]:
    """A lower bound on a full-attention decode step in ms, and what it
    counts: the weights and every layer's K/V of the ``kv_len + 1``
    positions the step attends to, each read once."""
    from repro_torch.serve.engine import tree_leaves

    parts = {"weights": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
             "K/V": cfg.num_layers * B * (kv_len + 1) * 2 * 2 * cfg.num_kv_heads * cfg.hd}
    ms = {k: v / H100_BYTES_PER_S * 1e3 for k, v in parts.items()}
    what = " + ".join(f"{k} {parts[k] / 1e9:.3f} GB ({ms[k]:.3f} ms)" for k in parts)
    return sum(ms.values()), f"bound ({what}) read once"


def vlm_continuation(api, params, tokens, embeds, decoded, S, steps,
                     cache_len) -> dict:
    """The continuation test of phase 13: ``decoded``, the logits of
    ``steps`` dense decode steps after prefill(S) over ``embeds``, against
    the last logits of prefill(S + n) over the same embeds, n = 1..steps;
    and the planted fault, the same steps after a prefill in which every
    sequence carries its neighbour's embeds (rolled one along the batch),
    against the same reference.  Returns ``near_tie`` of both and the
    reference's mean and largest |logit|."""
    full = prefill_logits(api, params, {"embeds": embeds}, tokens, S, steps,
                          cache_len)
    _, bad = api.prefill(params, {"tokens": tokens[:, :S],
                                  "embeds": embeds.roll(1, dims=0)},
                         cache_len=cache_len)
    faulted = decode_logits(api.decode_step, params, bad, tokens, S, steps)
    return {"cont": near_tie(full, decoded), "fault": near_tie(full, faulted),
            "logit_abs": full.abs().mean().item(),
            "logit_max": full.abs().max().item()}


def vlm_path(api, params, gen, flash_cuda, paged_cuda, B, S, cache_len, steps,
             page) -> dict:
    """qwen2_vl_72b: phase 4's path (``main_path``) with a seeded embeds
    prefix in every prefill, its profiles beside the weights and K/V read
    once, then ``vlm_continuation`` on the eager dense steps: within
    TOL_CONT_LOGITS, and the planted fault outside it.  Returns
    ``main_path``'s result."""
    cfg = api.cfg
    embeds = vlm_embeds(cfg, gen, B, S)
    bound = kv_step_bound(params, cfg, B, S + steps - 1)
    r = main_path(api, params, gen, flash_cuda, paged_cuda, B=B, S=S,
                  cache_len=cache_len, steps=steps, page=page,
                  extra={"embeds": embeds}, step_bound=bound)
    with torch.inference_mode():
        sync(api.device)
        t0 = time.perf_counter()
        c = vlm_continuation(api, params, r["tokens"], embeds, r["dense_logits"],
                             S, steps, cache_len)
        sync(api.device)
    tol = TOL_CONT_LOGITS[cfg.name]
    for what, (err, same, n_tok, gap) in (("", c["cont"]), (
            ", embeds rolled one sequence (planted fault)", c["fault"])):
        log(f"{cfg.name} prefill({S}, {embeds.shape[1]} embeds rows) + n decode "
            f"steps vs prefill({S}+n), n = 1..{steps}{what}: max|err| {err:.4f} "
            f"(limit {tol}; mean |logit| {c['logit_abs']:.4f}, largest "
            f"{c['logit_max']:.4f}); greedy tokens equal {same}/{n_tok}, largest "
            f"prefill-logit gap where they differ {gap:.4f}")
    log(f"{cfg.name} continuation run {time.perf_counter() - t0:.1f} s")
    err, _, _, gap = c["cont"]
    if not (torch.isfinite(r["dense_logits"]).all() and err <= tol and gap <= tol):
        raise SystemExit(f"{cfg.name} decode does not continue its prefill")
    if c["fault"][0] <= tol:
        raise SystemExit(f"{cfg.name}: the planted fault passes the limit {tol}")
    return r


def dense_path(api, params, gen, flash_cuda, paged_cuda) -> dict:
    """Phases 19-20: phase 4's path (``main_path`` at its defaults: every
    flash launch on wgmma, every paged launch on the split route, paged
    decode within TOL_PAGED_LOGITS of dense, eager and captured, profiles
    beside the weights read once), then two more readings of its eager
    steps: the paged steps again with the kernel called without each
    sequence's first page (the planted fault of phases 9-10), which must
    fail that limit, and the dense steps against the last logits of
    prefill(S + n), within TOL_CONT_LOGITS.  Returns ``main_path``'s
    result."""
    from unittest import mock

    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import tree_clone

    cfg = api.cfg
    S, steps, cache_len = 512, 8, 1024          # main_path's defaults
    log(f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd} (G "
        f"{cfg.num_heads // cfg.num_kv_heads}), weights "
        f"{weights_ms(params) * H100_BYTES_PER_S / 1e12:.3f} GB")
    r = main_path(api, params, gen, flash_cuda, paged_cuda)

    def paged_step(p_, c_, n_, t_):
        return TF.lm_decode_step_paged(p_, cfg, c_, n_, t_)

    dense = r["dense_logits"]
    with torch.inference_mode():
        # each step writes its own position before reading it, so the cache
        # the eager steps left gives the same steps again
        with mock.patch.object(TF, "paged_attention",
                               first_page_dropped(TF.paged_attention)):
            fault = decode_logits(paged_step, params, tree_clone(r["paged"]),
                                  r["tokens"], S, steps)
        full = prefill_logits(api, params, {}, r["tokens"], S, steps, cache_len)
    tol, tol_cont = TOL_PAGED_LOGITS[cfg.name], TOL_CONT_LOGITS[cfg.name]
    readings = {"fault": near_tie(dense, fault), "cont": near_tie(full, dense)}
    err, same, n_tok, gap = readings["fault"]
    log(f"{cfg.name} paged vs dense decode, first page dropped (planted fault): "
        f"max|err| {err:.4f} (must fail the limit {tol}; mean |logit| "
        f"{dense.abs().mean().item():.4f}); greedy tokens equal {same}/{n_tok}")
    err, same, n_tok, gap = readings["cont"]
    log(f"{cfg.name} prefill({S}) + n dense decode steps vs prefill({S}+n), n = "
        f"1..{steps}: max|err| {err:.4f} (limit {tol_cont}; mean |logit| "
        f"{full.abs().mean().item():.4f}); greedy tokens equal {same}/{n_tok}, "
        f"largest prefill-logit gap where they differ {gap:.4f}")
    if not readings["fault"][0] > tol:
        raise SystemExit(f"{cfg.name}: the planted fault passes the limit {tol}")
    if not (err <= tol_cont and gap <= tol_cont):
        raise SystemExit(f"{cfg.name} decode does not continue its prefill")
    return r


def weights_ms(params) -> float:
    """A lower bound on a decode step's time in ms: its weights read once
    over the card's memory rate (the cache it also reads is left out)."""
    from repro_torch.serve.engine import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves(params)) / H100_BYTES_PER_S * 1e3


def profile_steps(label: str, step, t0: int, n: int,
                  bound: float | None = None,
                  bound_what: str = "weights read once") -> None:
    """Device busy share and kernel launches of ``n`` steps, from a
    torch.profiler trace (the positions rewrite what the steps wrote),
    beside ``bound``, a lower bound on the step's time in ms (``bound_what``
    says what it counts), where given.  Busy time sums
    the device's own events only: a CPU op's self device time repeats that
    of the kernels it launched, and a user annotation's device range (the
    port's ``repro_torch.*`` spans) that of the kernels inside it."""
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
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events  # cudaLaunchKernelExC: clusters
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))) / n
    graphs = sum(e.count for e in events
                 if e.key.startswith(("cudaGraphLaunch", "cuGraphLaunch"))) / n
    kernel_count = sum(e.count for e in kernels) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    ours = [(name, sum(e.self_device_time_total for e in es) / 1e3 / n,
             sum(e.count for e in es) / n) for name in PORT_KERNELS
            if (es := [e for e in kernels
                       if re.search(rf"::{name}[<(]", e.key)])]
    log(f"{label} step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {100 * (1 - busy / wall):.1f}%), {launches:.0f} kernel launches, "
        f"{graphs:.0f} graph launches, {kernel_count:.0f} device events"
        + ("" if bound is None else
           f"; {bound_what} {bound:.3f} ms ({busy / bound:.1f}x in busy time)")
        + "; top: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                    for e in top)
        + "; port kernels: " + ("; ".join(
            f"{name} {ms:.3f} ms in {count:.0f} launches"
            for name, ms, count in ours) or "none"))


# ---------------------------------------------------------------------------
# Phases 5 and 6: serving and DDS KV paging.
# ---------------------------------------------------------------------------


def serve_batch(api, params, name: str, cache_len: int = 256) -> None:
    """The same 16 requests through BatchScheduler twice in this call: with
    its decode step captured (``DecodeGraph``, what it does on a card) and
    with ``api.decode_step`` put in its place (eager).  Both must complete
    every request with the same tokens."""
    from repro_torch.serve.engine import BatchScheduler, DecodeGraph, Request

    n_req, slots, max_new = 16, 4, 16
    runs = {}
    for mode in ("graph", "eager"):
        sched = BatchScheduler(api, params, slots=slots, cache_len=cache_len)
        if not isinstance(sched._decode, DecodeGraph):
            raise SystemExit("BatchScheduler on the card did not build a DecodeGraph")
        if mode == "eager":
            sched._decode = api.decode_step
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, api.cfg.vocab_size, size=4),
                        max_new=max_new) for i in range(n_req)]
        for r in reqs:
            sched.submit(r)
        sync(api.device)
        t0 = time.perf_counter()
        done = sched.step()
        sync(api.device)
        first = time.perf_counter() - t0
        steps = 1
        while done < n_req and steps < 1000:
            done += sched.step()
            steps += 1
        sync(api.device)
        dt = time.perf_counter() - t0
        if done != n_req or any(len(r.generated) != max_new for r in reqs):
            raise SystemExit(f"BatchScheduler ({mode}) completed {done}/{n_req} "
                             "requests")
        runs[mode] = dict(tok_s=n_req * max_new / dt, ms=dt * 1e3 / steps,
                          rest_ms=(dt - first) * 1e3 / (steps - 1),
                          first_ms=first * 1e3, steps=steps,
                          tokens=[r.generated for r in reqs])
    same = runs["graph"]["tokens"] == runs["eager"]["tokens"]
    log(f"BatchScheduler: {n_req} requests x {max_new} tokens over {slots} "
        f"slots, {api.cfg.name} on {name}: "
        + "; ".join(f"{m} {r['tok_s']:.1f} tok/s ({r['ms']:.3f} ms/step over "
                    f"{r['steps']} steps; first step {r['first_ms']:.1f} ms, "
                    f"the rest {r['rest_ms']:.3f} ms/step)"
                    for m, r in runs.items())
        + f"; generated tokens equal: {same}")
    if not same:
        raise SystemExit("BatchScheduler: captured and eager decode generated "
                         "different tokens")


def kv_paging(paged: dict, blocks: list[tuple[int, int]], hbm_blocks: int) -> dict:
    """Spill the K pages ``blocks`` (layer, physical page) of the pool to the
    DDS page store and fetch the cold ones back through the offload path;
    each must come back bit-exact.  A K page larger than ``KV_STORE_PAYLOAD``
    spans several store pages (``PagedKVEngine.parts``), each an offloaded
    read."""
    from repro_torch.serve.engine import PagedKVEngine
    from repro_torch.storage.pagestore import PAGE_HDR, PageStore

    pool = paged["k_pool"]
    page_bytes = pool[0, 0].numel() * pool.element_size()
    payload = min(page_bytes, KV_STORE_PAYLOAD)
    parts = -(-page_bytes // payload)
    store = PageStore(page_size=payload + PAGE_HDR.size,
                      num_pages=parts * len(blocks))
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
    if (eng.parts != parts or eng.spills != len(blocks) - hbm_blocks
            or eng.fetches != len(cold) or offloaded != parts * len(cold)
            or store.host_served):
        raise SystemExit(f"kv paging: {eng.parts} store pages a K page, spills "
                         f"{eng.spills} fetches {eng.fetches} offloaded "
                         f"{offloaded} host-served {store.host_served}")
    return {"page_bytes": page_bytes, "parts": parts, "spills": eng.spills,
            "fetches": eng.fetches, "offloaded": offloaded}


# ---------------------------------------------------------------------------
# Phase 14: training and DDS checkpoints.
# ---------------------------------------------------------------------------


def attn_grads(g) -> dict:
    """The wq/wk/wv/wo gradients of every attention layer, fp32, by (layer,
    name): every stack of attention weights (``blocks``; gemma3's window,
    global and tail stacks; the encoder's and the decoder's self- and
    cross-attention) split over its leading layer axes."""
    from repro_torch.tree import leaf_paths

    out = {}
    for path, t in leaf_paths(g):
        if path[-2:-1] in (("attn",), ("self_attn",), ("cross_attn",)) and path[-1] in (
                "wq", "wk", "wv", "wo"):
            for i, w in enumerate(t.reshape(-1, *t.shape[-2:])):
                out[("/".join(path[:-1]) + f"[{i}]", path[-1])] = w.float()
    return out


def grad_reading(g, got: dict, ref: dict, ref_norm: float) -> tuple[float, str]:
    """A gradient gate's reading: the worst over ``ref``'s leaves of
    ||got - ref|| / ||ref||, and the relative difference of ``g``'s global
    norm from ``ref_norm``; with the leaf or norm that gave it."""
    from repro_torch.optim.adamw import global_norm

    per = {f"{k[0]} {k[1]}": (got[k] - r).norm().item() / r.norm().item()
           for k, r in ref.items()}
    per["global norm"] = abs(global_norm(g).item() - ref_norm) / ref_norm
    worst = max(per, key=per.get)
    return per[worst], worst


def bwd_faults() -> dict:
    """Planted faults of the flash backward: each breaks the (dq, dk, dv)
    that ``FlashAttentionFn``'s backward gets from the kernel."""
    def unscaled_dq(dq, dk, dv):
        return dq * dq.shape[-1] ** 0.5, dk, dv

    def tile_zeroed(keys):
        def fn(dq, dk, dv):
            dk, dv = dk.clone(), dv.clone()
            dk[:, keys], dv[:, keys] = 0, 0
            return dq, dk, dv
        return fn

    return {"dq left unscaled": unscaled_dq,
            "the first key tile's dK/dV zeroed": tile_zeroed(slice(0, 64)),
            "the last key tile's dK/dV zeroed": tile_zeroed(slice(-64, None))}


def flash_train_want(cfg, bwd_route: str, n: int = 1) -> dict:
    """Flash launches by route of ``n`` value_and_grads: every forward on
    the tensor cores (bf16), every backward on ``bwd_route``."""
    fwd, bwd, _, _ = reduced_train_launches(cfg)
    return {"flash_attention": {"wgmma": n * fwd, "simt": 0},
            "flash_attention_bwd": {r: n * bwd * (r == bwd_route)
                                    for r in ("wgmma", "simt")}}


def train_gate(api, params, batch, tol: float, bwd_route: str) -> float:
    """The first step's gradients through the kernels (their launches by
    route held to ``flash_train_want``) against the plain attention path
    (``flash_attention_xla`` under autograd on the card, patched into
    ``models.layers`` and ``models.encdec``), then with each planted fault
    of ``bwd_faults``: the kernels must pass ``tol``; the first two faults
    must fail it, the third is read only.  Returns the kernels' reading."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention_xla
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as TL
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.loop import value_and_grad

    kernel_fa = TL.flash_attention, ED.flash_attention

    def plain(q, k, v, *, causal, window=None, q_offset=None, **_):
        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)

    TL.flash_attention = ED.flash_attention = plain
    try:
        t0 = time.perf_counter()
        _, g = value_and_grad(api, params, batch)
        sync(api.device)
        plain_s = time.perf_counter() - t0
    finally:
        TL.flash_attention, ED.flash_attention = kernel_fa
    ref, ref_norm = attn_grads(g), global_norm(g).item()
    del g
    before = routes_now()
    t0 = time.perf_counter()
    _, g = value_and_grad(api, params, batch)
    sync(api.device)
    kernel_s = time.perf_counter() - t0
    want = flash_train_want(api.cfg, bwd_route)
    launches = {k: v for k, v in routes_since(before).items() if k in want}
    reading, worst = grad_reading(g, attn_grads(g), ref, ref_norm)
    del g
    log(f"{api.cfg.name} gradient gate: first step's wq/wk/wv/wo gradients of all "
        f"{len(ref) // 4} attention layers and the global norm ({ref_norm:.4f}), "
        f"kernels ({kernel_s:.2f} s; launches {launches}) against the plain "
        f"attention path ({plain_s:.2f} s): {reading:.4e} at {worst} (limit {tol})")
    if launches != want:
        raise SystemExit(f"{api.cfg.name} gradient gate: launches differ from {want}")
    real = FK.FlashAttentionFn.backward

    def planted(fault):
        def backward(ctx, dout):
            dq, dk, dv, *rest = real(ctx, dout)
            return (*fault(dq, dk, dv), *rest)
        return staticmethod(backward)

    passed = []
    try:
        for i, (name, fault) in enumerate(bwd_faults().items()):
            FK.FlashAttentionFn.backward = planted(fault)
            _, g = value_and_grad(api, params, batch)
            r, worst = grad_reading(g, attn_grads(g), ref, ref_norm)
            del g
            must = i < 2
            log(f"{api.cfg.name} gradient gate, planted fault ({name}): {r:.4e} at {worst} "
                f"({'must fail' if must else 'read only'}: "
                f"{'fails' if r > tol else 'passes'} the limit)")
            if must and r <= tol:
                passed.append(name)
    finally:
        FK.FlashAttentionFn.backward = staticmethod(real)
    if reading > tol or passed:
        raise SystemExit(f"{api.cfg.name} gradient gate failed (reading {reading:.4e}, "
                         f"limit {tol}; planted faults that pass: {passed})")
    return reading


def micro_gate(api, params, batch, tcfg) -> float:
    """One step with ``microbatch=2`` against one with 1 from the same
    state (step 0, where the warmup's lr is 0, so the moments carry the
    step): the loss, the grad norm and the worst ||mu2 - mu1|| / ||mu1||
    over the leaves, held to ``TOL_TRAIN_MICRO``."""
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import make_train_fn
    from repro_torch.tree import leaf_paths

    res = {}
    for n in (1, 2):
        _, opt, _, m = make_train_fn(api, dataclasses.replace(tcfg, microbatch=n))(
            params, adamw_init(params), None, batch, 0)
        res[n] = ({p: t for p, t in leaf_paths(opt.mu)}, float(m["loss"]),
                  float(m["grad_norm"]))
        del opt
    mu = max((res[2][0][p] - t).norm().item() / t.norm().item()
             for p, t in res[1][0].items())
    reading = max(mu, abs(res[2][1] - res[1][1]) / res[1][1],
                  abs(res[2][2] - res[1][2]) / res[1][2])
    log(f"microbatch 2 against 1, one step: loss {res[1][1]:.6f} vs "
        f"{res[2][1]:.6f}, grad norm {res[1][2]:.6f} vs {res[2][2]:.6f}, worst "
        f"relative moment difference {mu:.4e}; reading {reading:.4e} (limit "
        f"{TOL_TRAIN_MICRO})")
    if reading > TOL_TRAIN_MICRO:
        raise SystemExit("microbatch 2 disagrees with microbatch 1")
    return reading


def profile_train_step(run_step, device, share: str = "flash_bwd",
                       share_name: str = "flash backward") -> dict:
    """Device busy time (ms), the largest device items and the port's
    kernels of one train step (``run_step()``), with the time and share of
    the busy time of the port's kernels whose names start with ``share``
    (``share_name``), from a torch.profiler trace (device events only, not
    the device ranges of user annotations such as the port's spans).
    Returns {"busy": ms, "share_ms": ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        sync(device)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    ours = {name: (sum(e.self_device_time_total for e in es) / 1e3,
                   sum(e.count for e in es)) for name in PORT_KERNELS
            if (es := [e for e in kernels if re.search(rf"::{name}[<(]", e.key)])}
    part = sum(ms for name, (ms, _) in ours.items() if name.startswith(share))
    log("train step profile: device busy " f"{busy:.1f} ms in "
        f"{sum(e.count for e in kernels)} device events; top: "
        + "; ".join(f"{e.key[:56]} {e.self_device_time_total / 1e3:.1f} ms "
                    f"x{e.count}" for e in top)
        + "; port kernels: " + "; ".join(f"{name} {ms:.1f} ms x{count}"
                                        for name, (ms, count) in ours.items())
        + f"; {share_name} {part:.1f} ms ({100 * part / busy:.1f}% of busy)")
    return {"busy": busy, "share_ms": part}


def train_path(api, params, gen, seed, flash_cuda, bwd_cuda) -> dict:
    """Phase 14: the gradient gate and the microbatch gate on the first
    batch, then ``TRAIN["steps"]`` Trainer steps from ``params`` with a
    DDS checkpoint of ``{params, mu, nu}`` at ``TRAIN["ckpt_at"]``
    (the Trainer's ``save_async``), the state there kept on the card; a
    fresh Trainer (weights from another draw) restored from the checkpoint,
    its leaves held bit-exact, and resumed under a ``TrainSupervisor`` that
    loses a host at ``TRAIN["crash"]``, restores the checkpoint again and
    replays: every loss must equal the uninterrupted run's bit for bit;
    then ``dots_steps``.  Returns the backward launches of the
    uninterrupted run, the gates' readings, the step's wall and busy ms and
    the "dots" readings."""
    from repro_torch.data.pipeline import BatchSpec, TokenPipeline
    from repro_torch.launch.train import server_for
    from repro_torch.serve.engine import tree_clone
    from repro_torch.storage.checkpoint import CheckpointManager
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths

    cfg, B, S = api.cfg, TRAIN["B"], TRAIN["S"]
    pipe = TokenPipeline(BatchSpec(B, S, cfg.vocab_size), seed, structured=True)
    tcfg = TrainConfig(warmup_steps=2)
    dev = api.device
    batch0 = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
    gate = train_gate(api, params, batch0, TOL_TRAIN_GRADS, "wgmma")
    micro = micro_gate(api, params, batch0, tcfg)
    del batch0
    n, at = TRAIN["steps"], TRAIN["ckpt_at"]
    straight = Trainer(api, tcfg, pipe, ckpt_every=at, params=params)
    mgr = CheckpointManager(server_for(straight.state(), keep=1), keep=1)
    straight.ckpt = mgr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = flash_train_want(cfg, "wgmma")
    flash_cuda.launches, bwd_cuda.launches = 0, 0
    for fn in (flash_cuda, bwd_cuda):
        for r in fn.launches_by_route:
            fn.launches_by_route[r] = 0
    recs = counted_steps(lambda: straight.run(1)[-1], at, dev, want, "uninterrupted")
    info = mgr._history[-1]
    saved = tree_clone(straight.state())
    straight.ckpt = None
    recs += counted_steps(lambda: straight.run(1)[-1], n - at, dev, want, "uninterrupted")
    launches = {"flash_attention": dict(flash_cuda.launches_by_route),
                "flash_attention_bwd": dict(bwd_cuda.launches_by_route)}
    peak = max(r["peak_gib"] for r in recs)
    losses = [r["loss"] for r in recs]
    log(f"uninterrupted run, {n} steps of {B} x {S}: losses {losses}; launches "
        f"{launches}; peak device memory {peak:.3f} GiB (state {at} steps in "
        "kept on the card for the resume check)")
    k = TRAIN["mean_of"]
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    log(f"loss, mean of the first {k} steps {first:.6f}, of the last {k} {last:.6f}")
    if not last < first:
        raise SystemExit(f"training loss not falling: {losses}")
    log(f"checkpoint at step {info.step} through the Trainer's save_async: "
        f"{info.leaves} leaves, {info.nbytes / 1e9:.3f} GB written through the "
        f"DDS server in {info.wall_s:.2f} s ({info.nbytes / info.wall_s / 1e9:.3f} GB/s); "
        f"step {at - 1} with the host copy and the wait: {recs[at - 1]['ms']:.1f} ms")
    del straight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    resumed = Trainer(api, tcfg, pipe, checkpoint_mgr=mgr,
                      generator=torch.Generator(device=dev).manual_seed(seed + 1))
    sync(dev)
    t0 = time.perf_counter()
    if not resumed.restore_latest() or resumed.step != at:
        raise SystemExit("restore_latest found no checkpoint")
    sync(dev)
    restore_s = time.perf_counter() - t0
    exact = all(torch.equal(a, b) for (_, a), (_, b)
                in zip(leaf_paths(resumed.state()), leaf_paths(saved)))
    log(f"restored step {at} into a fresh Trainer in {restore_s:.2f} s "
        f"({info.nbytes / restore_s / 1e9:.3f} GB/s): every leaf "
        f"{'bit-exact' if exact else 'DIFFERS'}")
    del saved
    if not exact:
        raise SystemExit("the restored train state differs from the saved one")
    # the resumed Trainer runs on to step n under a TrainSupervisor of
    # TRAIN["hosts"] hosts: TRAIN["crash"] loses one, and the supervisor
    # restores the step-``at`` checkpoint from the DDS store and replays
    sup = supervised(resumed, TRAIN["hosts"], TRAIN["crash"])
    crash_at = next(iter(TRAIN["crash"]))
    again = counted_steps(lambda: sup.run(resumed.step + 1)[-1], crash_at - at,
                          dev, want, "supervised")
    sync(dev)
    t0 = time.perf_counter()
    sup.run(n)
    sync(dev)
    rest_s = time.perf_counter() - t0
    again += resumed.history[len(again):]
    ev = sup.events
    log(f"TrainSupervisor over the resumed Trainer, to step {n}: events "
        f"{[dataclasses.astuple(e) for e in ev]}, restarts {sup.restarts}, "
        f"surviving hosts {sup.hosts}; steps run {[r['step'] for r in again]}; "
        f"the restart's restore {sup.restore_s:.2f} s "
        f"({info.nbytes / sup.restore_s / 1e9:.3f} GB/s), the crash to step {n} "
        f"{rest_s:.2f} s")
    if (sup.restarts != 1 or len(sup.hosts) != TRAIN["hosts"] - 1
            or [(e.step, e.kind, e.action) for e in ev] != [(crash_at, "crash", "restart_shrunk")]
            or resumed.step != n
            or [r["step"] for r in again] != (list(range(at, crash_at))
                                              + list(range(at, n)))):
        raise SystemExit("the supervisor did not restart once from the checkpoint")
    if [r["loss"] for r in again] != [losses[r["step"]] for r in again]:
        raise SystemExit(f"resumed and replayed losses {[r['loss'] for r in again]} "
                         f"differ from the uninterrupted run's {losses[at:]}")
    log(f"resumed and replayed losses equal the uninterrupted run's bit for bit: "
        f"{[r['loss'] for r in again]}")
    resumed.ckpt = None
    busy = profile_train_step(lambda: resumed.run(1), dev)["busy"]
    wall = statistics.median(r["ms"] for r in recs[1:] if r["step"] != at - 1)
    log(f"train step: wall {wall:.1f} ms (median of the uninterrupted steps "
        f"but the first and the checkpoint's), device busy {busy:.1f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    start = tree_to(resumed.params, "cpu")
    del resumed, sup
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dots = dots_steps(api, start, pipe, tcfg, n + 1, want)
    return {"launches": launches, "gate": gate, "micro": micro, "wall": wall,
            "busy": busy, "dots": dots}


def supervised(trainer, hosts: int, crash: dict):
    """A ``TrainSupervisor`` over ``trainer`` with ``hosts`` hosts that loses
    ``crash[step]`` at that step, its ``restore_s`` the wall of its
    restart's ``restore_latest``."""
    from repro_torch.distributed.fault_tolerance import TrainSupervisor

    pending = dict(crash)
    sup = TrainSupervisor(trainer, [f"host{i}" for i in range(hosts)],
                          inject_failure=lambda s: pending.pop(s, None))
    restore, sup.restore_s = trainer.restore_latest, 0.0

    def timed():
        sync(trainer.api.device)
        t0 = time.perf_counter()
        ok = restore()
        sync(trainer.api.device)
        sup.restore_s += time.perf_counter() - t0
        return ok

    trainer.restore_latest = timed
    return sup


def dots_steps(api, start, pipe, tcfg, step0: int, want: dict) -> dict:
    """Phase 14's ``remat="dots"`` readings from the params ``start`` (on
    the host) and the batches from ``step0``: the gradients of one batch at
    "dots" against "full" (each leaf's ||g - g_full|| / ||g_full||, within
    TOL_TRAIN_GRADS), then TRAIN["dots_steps"] Trainer steps at each policy
    from fresh moments (ms, peak memory, launches held to ``want``), their
    losses and grad norms side by side, and one profiled "dots" step.
    Returns each policy's median ms and peak GiB."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import Trainer, value_and_grad
    from repro_torch.tree import leaf_paths, tree_map

    dev = api.device
    apis = {"full": api, "dots": build_model(
        dataclasses.replace(api.cfg, remat="dots"), dev)}
    params = tree_to(start, dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(step0).items()}
    grads = {}
    for policy, a in apis.items():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        grads[policy] = value_and_grad(a, params, batch)
        log(f"remat {policy}: value_and_grad peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30 if dev.type == 'cuda' else 0:.3f} GiB")
    (loss_f, g_full), (loss_d, g_dots) = grads["full"], grads["dots"]
    worst, where, equal = 0.0, "", 0
    for (path, a), (_, b) in zip(leaf_paths(g_dots), leaf_paths(g_full)):
        rel = ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        equal += torch.equal(a, b)
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    n_leaves = len(leaf_paths(g_full))
    log(f"remat dots vs full, gradients of step {step0}'s batch from the same "
        f"params: loss {float(loss_d):.6f} vs {float(loss_f):.6f}; {equal} of "
        f"{n_leaves} leaves bit-equal; worst ||g - g_full|| / ||g_full|| "
        f"{worst:.3g}{f' at {where}' * bool(where)} (limit {TOL_TRAIN_GRADS})")
    del grads, g_full, g_dots, params
    if worst > TOL_TRAIN_GRADS:
        raise SystemExit("the dots policy's gradients disagree with full remat")
    out, recs = {}, {}
    for policy, a in apis.items():
        trainer = Trainer(a, tcfg, pipe, params=tree_map(
            lambda t: t.to(dev, copy=True), start))
        trainer.step = step0
        recs[policy] = counted_steps(lambda: trainer.run(1)[-1], TRAIN["dots_steps"],
                                     dev, want, f"remat {policy}")
        if policy == "dots":
            profile_train_step(lambda: trainer.run(1), dev)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[policy] = {"ms": statistics.median(r["ms"] for r in recs[policy][1:]),
                       "peak_gib": max(r["peak_gib"] for r in recs[policy])}
    same = [(r["loss"], r["grad_norm"]) for r in recs["dots"]] == \
        [(r["loss"], r["grad_norm"]) for r in recs["full"]]
    log(f"remat dots vs full, {TRAIN['dots_steps']} Trainer steps from step {step0} "
        "(fresh moments): " + "; ".join(
            f"{p} {o['ms']:.1f} ms a step (median of the last "
            f"{TRAIN['dots_steps'] - 1}), peak {o['peak_gib']:.3f} GiB"
            for p, o in out.items())
        + f"; losses and grad norms equal bit for bit: {same}")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the gated-linear-attention family trains.
# ---------------------------------------------------------------------------


def gla_leaves(g, cfg) -> dict:
    """The gradients of the leaves that feed the scan's inputs, fp32, by
    (layer, name): RWKV6's decay MLP (wd_a, wd_b) and key and value
    projections; Mamba2's B/C, x/z and dt projections and A_log."""
    if cfg.family == "ssm":
        t = g["blocks"]["time"]
        return {(l, n): t[n][l].float() for n in ("wd_a", "wd_b", "w_k", "w_v")
                for l in range(cfg.num_layers)}
    names = ("in_bc", "in_xz", "in_dt", "A_log")
    m = g["groups"]["mamba"]
    out = {(f"group {i}.{j}", n): m[n][i, j].float() for n in names
           for i in range(m[n].shape[0]) for j in range(m[n].shape[1])}
    if "tail" in g:
        t = g["tail"]["mamba"]
        out.update({(f"tail {i}", n): t[n][i].float() for n in names
                    for i in range(t[n].shape[0])})
    return out


def gla_bwd_faults(chunk: int = 128) -> dict:
    """Planted faults of the gla_scan backward: each breaks the (dq, dk,
    dv, dw) that ``GlaScanFn``'s backward gets from the kernel."""
    def dw_zeroed(dq, dk, dv, dw):
        return dq, dk, dv, torch.zeros_like(dw)

    def carry_dropped(dq, dk, dv, dw):
        dk, dv = dk.clone(), dv.clone()
        dk[:, :, :-chunk], dv[:, :, :-chunk] = 0, 0
        return dq, dk, dv, dw

    return {"dw zeroed": dw_zeroed,
            "dk and dv zeroed before the last chunk (a dropped dS carry)": carry_dropped}


def train_counters():
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.ssm_scan.kernel import gla_scan_bwd_cuda, gla_scan_cuda

    return {"gla_scan": gla_scan_cuda, "gla_scan_bwd": gla_scan_bwd_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda}


def routes_since(before: dict) -> dict:
    """Launches by route of ``train_counters()`` since ``before``."""
    return {name: {r: c - before[name][r] for r, c in fn.launches_by_route.items()}
            for name, fn in train_counters().items()}


def routes_now() -> dict:
    return {name: dict(fn.launches_by_route) for name, fn in train_counters().items()}


def ssm_train_want(cfg) -> dict:
    """A step's launches by route: every forward and backward of the scan
    and of flash on the tensor cores (bf16)."""
    ffwd, fbwd, gfwd, gbwd = reduced_train_launches(cfg)
    return {"gla_scan": {"mma": gfwd, "simt": 0},
            "gla_scan_bwd": {"mma": gbwd, "simt": 0},
            "flash_attention": {"wgmma": ffwd, "simt": 0},
            "flash_attention_bwd": {"wgmma": fbwd, "simt": 0}}


def ssm_train_gate(api, params, batch, step: int) -> float:
    """Step ``step``'s gradients through the kernels against the plain GLA
    path (``gla_scan_xla`` under autograd on the card, patched into
    ``models.ssm``), then with each planted fault of ``gla_bwd_faults``,
    each of which must fail ``TOL_SSM_TRAIN_GRADS``.  Every leaf the gate
    reads must have a nonzero plain gradient.  Returns the kernels'
    reading."""
    from repro_torch.kernels.ssm_scan import kernel as GK
    from repro_torch.kernels.ssm_scan.ops import gla_scan_xla
    from repro_torch.models import ssm as SSM
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.loop import value_and_grad

    cfg = api.cfg
    tol = TOL_SSM_TRAIN_GRADS[cfg.name]
    kernel_gla = SSM.gla_scan

    def plain(q, k, v, w, chunk=128):
        return gla_scan_xla(q, k, v, w, chunk=chunk)

    SSM.gla_scan = plain
    try:
        t0 = time.perf_counter()
        _, g = value_and_grad(api, params, batch)
        sync(api.device)
        plain_s = time.perf_counter() - t0
    finally:
        SSM.gla_scan = kernel_gla
    ref, ref_norm = gla_leaves(g, cfg), global_norm(g).item()
    del g
    zero = [k for k, r in ref.items() if not r.norm().item() > 0]
    if zero:
        raise SystemExit(f"{cfg.name} gradient gate at step {step}: the plain path's "
                         f"gradients of {zero} are zero, so the gate reads nothing")
    before = routes_now()
    t0 = time.perf_counter()
    _, g = value_and_grad(api, params, batch)
    sync(api.device)
    kernel_s = time.perf_counter() - t0
    launches = routes_since(before)
    reading, worst = grad_reading(g, gla_leaves(g, cfg), ref, ref_norm)
    del g
    log(f"{cfg.name} gradient gate: step {step}'s gradients of {len(ref)} leaves "
        f"({', '.join(sorted({n for _, n in ref}))}) and the global norm "
        f"({ref_norm:.4f}), kernels ({kernel_s:.2f} s; launches {launches}) against "
        f"the plain GLA path ({plain_s:.2f} s): {reading:.4e} at {worst} (limit {tol})")
    if launches != ssm_train_want(cfg) or reading > tol:
        raise SystemExit(f"{cfg.name} gradient gate failed")
    real = GK.GlaScanFn.backward

    def planted(fault):
        def backward(ctx, do, d_final):
            dq, dk, dv, dw, *rest = real(ctx, do, d_final)
            return (*fault(dq, dk, dv, dw), *rest)
        return staticmethod(backward)

    try:
        for name, fault in gla_bwd_faults().items():
            GK.GlaScanFn.backward = planted(fault)
            _, g = value_and_grad(api, params, batch)
            r, worst = grad_reading(g, gla_leaves(g, cfg), ref, ref_norm)
            del g
            log(f"{cfg.name} gradient gate, planted fault ({name}): {r:.4e} at {worst} "
                f"(must fail: {'fails' if r > tol else 'passes'} the limit)")
            if r <= tol:
                raise SystemExit(f"{cfg.name} gradient gate passed a planted fault ({name})")
    finally:
        GK.GlaScanFn.backward = staticmethod(real)
    return reading


def counted_steps(run_step, n: int, device, want: dict, label: str) -> list[dict]:
    """``n`` train steps (``run_step()`` returns a step's record) one at a
    time: each record with its wall ms (host clock, synchronised: the
    records read the metrics), its peak device memory and its launches by
    route of ``want``'s kernels, which must equal ``want``; the losses must
    be finite."""
    on_card = device.type == "cuda"
    recs = []
    for _ in range(n):
        before = routes_now()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync(device)
        t0 = time.perf_counter()
        rec = dict(run_step())
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        rec["launches"] = {k: v for k, v in routes_since(before).items() if k in want}
        log(f"{label} step {rec['step']}: loss {rec['loss']:.6f} grad norm "
            f"{rec['grad_norm']:.6f} lr {rec['lr']:.4e} {rec['ms']:.1f} ms peak "
            f"{rec['peak_gib']:.3f} GiB; launches {rec['launches']}")
        recs.append(rec)
    if any(r["launches"] != want for r in recs):
        raise SystemExit(f"{label} train steps' launches differ from {want} a step")
    if not all(np.isfinite(r["loss"]) for r in recs):
        raise SystemExit(f"{label} training loss not finite: {[r['loss'] for r in recs]}")
    return recs


def ssm_train_path(api, params, seed) -> dict:
    """Phase 15 for one model: ``SSM_TRAIN["steps"]`` Trainer steps from
    ``params`` (loss, grad norm, ms, peak memory and launches by route a
    step, held to ``ssm_train_want``), with the gradient gate on the
    parameters and batch of step ``SSM_GATE_STEP`` before that step runs,
    then one profiled step.  Returns the scan backward's launches over the
    steps, the gate's reading, the step's wall and busy ms."""
    from repro_torch.data.pipeline import BatchSpec, TokenPipeline
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg, B, S, dev = api.cfg, SSM_TRAIN["B"], SSM_TRAIN["S"], api.device
    pipe = TokenPipeline(BatchSpec(B, S, cfg.vocab_size), seed, structured=True)
    trainer = Trainer(api, TrainConfig(warmup_steps=2), pipe, params=params)
    del params
    want = ssm_train_want(cfg)
    gate_at = SSM_GATE_STEP[cfg.name]

    def run_step():
        return trainer.run(1)[-1]

    recs = counted_steps(run_step, gate_at, dev, want, cfg.name)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(gate_at).items()}
    gate = ssm_train_gate(api, trainer.params, batch, gate_at)
    del batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    recs += counted_steps(run_step, SSM_TRAIN["steps"] - gate_at, dev, want, cfg.name)
    bwd_launches = sum(r["launches"]["gla_scan_bwd"]["mma"] for r in recs)
    losses = [r["loss"] for r in recs]
    busy = profile_train_step(run_step, dev, "gla_bwd", "gla_scan backward")["busy"]
    wall = statistics.median(r["ms"] for r in recs[1:])
    log(f"{cfg.name} L{cfg.num_layers} train step at {B} x {S}: wall {wall:.1f} ms "
        f"(median of the steps but the first), device busy {busy:.1f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%); losses {losses} (mean of the first 3 "
        f"{np.mean(losses[:3]):.6f}, of the last 3 {np.mean(losses[-3:]):.6f}); "
        f"peak {max(r['peak_gib'] for r in recs):.3f} GiB")
    return {"launches": bwd_launches, "gate": gate, "wall_ms": wall, "busy_ms": busy}


# ---------------------------------------------------------------------------
# Phase 17: the sharded entry points on a 1 x 1 NCCL mesh.
# ---------------------------------------------------------------------------


def full(t):
    """A DTensor gathered whole (local on a 1 x 1 mesh); a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def sharded_path(tiny, train14, seed, flash_cuda, bwd_cuda, card) -> None:
    """Phase 17: a world of one over NCCL and its 1 x 1 ("data", "model")
    mesh (``launch.mesh.make_test_mesh``).  Serving: phase 4's TinyLlama
    weights (``tiny``) through ``make_serve_fns``' prefill (B x S into
    phase 4's cache length, ``num_layers`` flash launches on wgmma) and
    ``SHARDED["decode"]`` dense decode steps, held to phase 4's eager
    logits.  Training at full width and depth from the structured stream:
    ``SHARDED["steps"]`` steps of ``make_train_step``'s function and of the
    single-device out-of-place ``make_train_fn`` from the same params,
    moments and batches (launches by route a step held to phase 14's
    want; peak memory within the card), their losses, grad norms and
    params held to ``TOL_SHARDED_*``, then one profiled sharded step: its
    wall and idle share beside phase 14's (``train14``); one step at
    ``remat="dots"`` held to the first sharded step; then ``pod_path``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import BatchSpec, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.train.loop import (TrainConfig, abstract_init, make_train_fn,
                                        make_train_step)
    from repro_torch.tree import leaves, tree_clone

    mesh = make_test_mesh()
    log(f"phase 17 ({card}): {dist.get_backend()} world of {dist.get_world_size()}, "
        f"mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)} on "
        f"{mesh.device_type}")
    api = build_model(get_config("tinyllama_1p1b"))
    cfg, dev = api.cfg, api.device
    _, axes = abstract_init(api)
    params = tree_to(tiny["params"], dev)
    tokens = tiny["tokens"]
    B, S, n = tokens.shape[0], SHARDED["S"], SHARDED["decode"]
    pre, dec = make_serve_fns(api, mesh, axes, ShapeConfig("serve", "prefill", S, B))
    batch = {"tokens": tokens[:, :S]}
    prefill = pre(batch)
    with torch.no_grad():
        prefill(params, batch, SHARDED["cache_len"])   # sharding propagation, once
        before = routes_now()
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, SHARDED["cache_len"])
        sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launched = routes_since(before)["flash_attention"]
        step = dec(cache)
        cache0 = tree_clone(cache)
        lgs, ms = [], []
        for t in range(S, S + n):
            t0 = time.perf_counter()
            lg, cache = step(params, cache, t, tokens[:, t:t + 1])
            lgs.append(full(lg).float())
            ms.append((time.perf_counter() - t0) * 1e3)
        for label, fn in (("sharded prefill", lambda t: prefill(
                params, batch, SHARDED["cache_len"])),
                          ("sharded dense decode", lambda t: step(
                              params, cache, t, tokens[:, t:t + 1]))):
            profile_steps(f"{label} ({card})", fn, S + n - 2, 2,
                          *((weights_ms(params),) if "decode" in label else ()))
    e_pre = max_err(full(logits), tiny["prefill_logits"])
    e_dec = max_err(torch.stack(lgs), tiny["dense_logits"][:n])
    log(f"sharded serving ({card}): prefill {B} x {S} {prefill_ms:.3f} ms, flash "
        f"launches {launched}; {n} dense decode steps (eager): the first "
        f"{ms[0]:.3f} ms (sharding propagation), then {statistics.median(ms[1:]):.3f} "
        f"ms/step (median); against phase 4's eager logits: prefill max|err| "
        f"{e_pre:.4g}, decode {e_dec:.4g} (limit {TOL_SHARDED_LOGITS})")
    if launched != {"wgmma": cfg.num_layers, "simt": 0}:
        raise SystemExit(f"sharded prefill flash launches {launched}")
    if not (max(e_pre, e_dec) <= TOL_SHARDED_LOGITS
            and all(torch.isfinite(x).all() for x in lgs)):
        raise SystemExit("sharded serving disagrees with phase 4's logits")
    sharded_graph(step, mesh, params, cache0, tokens, S, lgs,
                  statistics.median(ms[1:]), tiny["dense_graph_ms"], card)
    del cache, cache0, step, logits, lgs
    torch.cuda.empty_cache()

    Bt, St, steps = SHARDED["train_B"], SHARDED["train_S"], SHARDED["steps"]
    pipe = TokenPipeline(BatchSpec(Bt, St, cfg.vocab_size), seed, structured=True)
    tcfg = TrainConfig(warmup_steps=2)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(i).items()}
               for i in range(steps + 1)]
    plain = make_train_fn(api, tcfg)
    p, o, ref = params, adamw_init(params), []
    for i in range(steps):
        p, o, _, m = plain(p, o, None, batches[i], i)
        ref.append((float(m["loss"]), float(m["grad_norm"])))
    ref_params = p
    del o
    torch.cuda.empty_cache()
    run = make_train_step(api, mesh, axes, tcfg)[1](batches[0])
    state = {"p": params, "o": adamw_init(params), "i": 0}

    def one():
        i = state["i"]
        state["p"], state["o"], _, m = run(state["p"], state["o"], None, batches[i], i)
        state["i"] += 1
        return {"step": i, **{k: float(full(v)) for k, v in m.items()}}

    want = flash_train_want(cfg, "wgmma")
    torch.cuda.reset_peak_memory_stats()
    recs = counted_steps(one, steps, dev, want, "sharded (1 x 1 mesh)")
    got = [(r["loss"], r["grad_norm"]) for r in recs]
    d_loss = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    d_norm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    big = max(t.float().abs().max().item() for t in leaves(ref_params))
    d_par = max(max_err(full(a), b) for a, b in zip(leaves(state["p"]),
                                                      leaves(ref_params))) / big
    equal = d_loss == d_norm == d_par == 0.0
    log(f"sharded vs single-device train steps ({card}), {steps} steps of "
        f"{Bt} x {St}: losses {got} vs {ref}; largest relative difference of "
        f"loss {d_loss:.3g}, grad norm {d_norm:.3g}, params {d_par:.3g} of the "
        f"largest |param| (limits {TOL_SHARDED_TRAIN}): "
        f"{'bit-equal' if equal else 'NOT bit-equal'}")
    if max(d_loss, d_norm, d_par) > TOL_SHARDED_TRAIN:
        raise SystemExit("the sharded train step disagrees with the single-device one")
    del ref_params, p
    peak = max(r["peak_gib"] for r in recs)
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    wall = statistics.median(r["ms"] for r in recs[1:])
    busy = profile_train_step(one, dev)["busy"]
    log(f"sharded train step ({card}): wall {wall:.1f} ms (median of steps 2-"
        f"{steps}), device busy {busy:.1f} ms (idle {100 * (1 - busy / wall):.1f}%); "
        f"phase 14's single-device step: wall {train14['wall']:.1f} ms, busy "
        f"{train14['busy']:.1f} ms (idle {100 * (1 - train14['busy'] / train14['wall']):.1f}%); "
        f"first sharded step {recs[0]['ms']:.1f} ms (sharding propagation); peak "
        f"{peak:.3f} GiB of {total:.3f}")
    if peak > total:
        raise SystemExit("the sharded train step does not fit the card")
    del state
    torch.cuda.empty_cache()
    # make_train_step at remat="dots": selective checkpointing over
    # DTensors (the FSDP gathers in the layer bodies recomputed, the
    # projections kept), one step from the same params, moments and batch
    # as the first sharded step above
    api_dots = build_model(dataclasses.replace(cfg, remat="dots"), dev)
    run_dots = make_train_step(api_dots, mesh, axes, tcfg)[1](batches[0])
    dots_state = {"o": adamw_init(params)}

    def one_dots():
        _, _, _, m = run_dots(params, dots_state.pop("o"), None, batches[0], 0)
        return {"step": 0, **{k: float(full(v)) for k, v in m.items()}}

    rec = counted_steps(one_dots, 1, dev, want, "sharded (1 x 1 mesh), remat dots")[0]
    d_dots = max(abs(rec[k] - recs[0][k]) / abs(recs[0][k]) for k in ("loss", "grad_norm"))
    log(f"sharded train step at remat dots ({card}): loss {rec['loss']!r}, grad norm "
        f"{rec['grad_norm']!r} against the full-remat sharded step's "
        f"{recs[0]['loss']!r}, {recs[0]['grad_norm']!r}: largest relative difference "
        f"{d_dots:.3g} (limit {TOL_SHARDED_TRAIN}); {rec['ms']:.1f} ms (its first "
        f"call: sharding propagation), peak {rec['peak_gib']:.3f} GiB")
    if d_dots > TOL_SHARDED_TRAIN:
        raise SystemExit("the sharded dots step disagrees with the full-remat one")
    del run_dots, dots_state
    torch.cuda.empty_cache()
    pod_path(api, params, batches[:steps], wall, card)
    dist.destroy_process_group()


def sharded_graph(run, mesh, params, cache0, tokens, S, eager_logits,
                  eager_ms, graph4_ms, card) -> None:
    """Phase 17 (a): ``DecodeGraph`` over ``make_serve_fns``' decode step
    ``run`` on the 1 x 1 mesh, with params, cache and tokens placed once by
    its ``in_specs``: the steps from ``S`` that gave ``eager_logits`` (the
    eager sharded steps, from the post-prefill cache ``cache0``) replayed
    twice, the second time timed, every logit equal to the eager one bit
    for bit; ms a step beside the eager sharded step and phase 4's captured
    step, and one profiled replay."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.serve.engine import DecodeGraph, tree_clone, tree_leaves

    pspecs, cspecs, tok_spec = run.in_specs
    p_d = sh.place(params, pspecs, mesh)
    start = sh.place(cache0, cspecs, mesh)
    static = tree_clone(start)
    tok_d = sh.place(tokens, tok_spec, mesh)
    dev, n = tokens.device, len(eager_logits)
    g = DecodeGraph(run, p_d, static)
    for rnd in range(2):
        for dst, src in zip(tree_leaves(static), tree_leaves(start)):
            if isinstance(dst, torch.Tensor):
                dst.to_local().copy_(src.to_local())
        sync(dev)
        t0 = time.perf_counter()
        got = [full(g(p_d, static, t, tok_d[:, t:t + 1])[0]).float()
               for t in range(S, S + n)]
        sync(dev)
        if rnd == 0:
            first_s = time.perf_counter() - t0
        ms = (time.perf_counter() - t0) / n * 1e3
        worst = max(max_err(a, b) for a, b in zip(got, eager_logits))
        if not all(torch.equal(a, b) for a, b in zip(got, eager_logits)):
            raise SystemExit(f"the captured sharded decode step differs from the "
                             f"eager sharded one (max|err| {worst:.3e})")
    log(f"captured sharded decode ({card}): {n} steps replayed from a CUDA graph "
        f"of make_serve_fns' step on DTensors, logits bit-equal to the eager "
        f"sharded steps; {ms:.3f} ms/step (first round {first_s * 1e3:.1f} ms: "
        f"{DecodeGraph.WARMUP} warm-up steps, the capture and {n} replays), eager "
        f"sharded {eager_ms:.3f} ms/step, phase 4's captured step {graph4_ms:.3f} "
        "ms/step")
    profile_steps(f"captured sharded decode ({card})",
                  lambda t: g(p_d, static, t, tok_d[:, t:t + 1]), S + n - 1, 1,
                  weights_ms(params))


def pod_path(api, params, batches, sharded_wall, card) -> None:
    """Phase 17 (b): ``make_compressed_pod_train_fn`` on a (pod 1, data 1,
    model 1) mesh over the phase's NCCL world against the single-device
    ``make_train_fn(compress_pod_grads=True)`` from the same params, fresh
    moments and zero residuals, ``len(batches)`` steps each: losses, grad
    norms, params and residuals held to ``TOL_SHARDED_TRAIN`` (bit-equal
    expected), flash launches by route a step held to phase 14's want, peak
    memory within the card; wall beside phase 17's sharded step."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import (TrainConfig, init_pod_compression,
                                        init_train_state,
                                        make_compressed_pod_train_fn, make_train_fn)
    from repro_torch.tree import leaves

    cfg, dev, steps = api.cfg, api.device, len(batches)
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    tcfg = TrainConfig(warmup_steps=2, compress_pod_grads=True)
    plain = make_train_fn(api, tcfg)
    p, o, c, _ = init_train_state(api, tcfg, params=params)
    ref = []
    for i in range(steps):
        p, o, c, m = plain(p, o, c, batches[i], i)
        ref.append((float(m["loss"]), float(m["grad_norm"])))
    ref_params, ref_err = p, c.error
    del o, c
    torch.cuda.empty_cache()
    run = make_compressed_pod_train_fn(api, tcfg, mesh)
    state = {"p": params, "o": adamw_init(params), "c": init_pod_compression(params, 1),
             "i": 0}

    def one():
        i = state["i"]
        state["p"], state["o"], state["c"], m = run(state["p"], state["o"], state["c"],
                                                    batches[i], i)
        state["i"] += 1
        return {"step": i, **{k: float(full(v)) for k, v in m.items()}}

    recs = counted_steps(one, steps, dev, flash_train_want(cfg, "wgmma"),
                         "compressed pod (1 x 1 x 1 mesh)")
    got = [(r["loss"], r["grad_norm"]) for r in recs]
    d_loss = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    d_norm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    big = max(t.float().abs().max().item() for t in leaves(ref_params))
    d_par = max(max_err(full(a), b) for a, b in zip(leaves(state["p"]),
                                                      leaves(ref_params))) / big
    big_e = max(t.abs().max().item() for t in leaves(ref_err))
    d_err = max(max_err(full(a)[0], b) for a, b in zip(leaves(state["c"].error),
                                                         leaves(ref_err))) / big_e
    equal = d_loss == d_norm == d_par == d_err == 0.0
    peak = max(r["peak_gib"] for r in recs)
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    wall = statistics.median(r["ms"] for r in recs[1:])
    log(f"compressed pod vs single-device compressed train steps ({card}), {steps} "
        f"steps of {tuple(batches[0]['tokens'].shape)}: losses {got} vs {ref}; "
        f"largest relative difference of loss {d_loss:.3g}, grad norm {d_norm:.3g}, "
        f"params {d_par:.3g} of the largest |param|, residuals {d_err:.3g} of the "
        f"largest |residual| (limits {TOL_SHARDED_TRAIN}): "
        f"{'bit-equal' if equal else 'NOT bit-equal'}; wall {wall:.1f} ms (median of "
        f"steps 2-{steps}; the sharded step {sharded_wall:.1f} ms), first step "
        f"{recs[0]['ms']:.1f} ms; peak {peak:.3f} GiB of {total:.3f}")
    if max(d_loss, d_norm, d_par, d_err) > TOL_SHARDED_TRAIN:
        raise SystemExit("the compressed pod train step disagrees with the "
                         "single-device compressed step")
    if peak > total:
        raise SystemExit("the compressed pod train step does not fit the card")


def dryrun_path(card) -> None:
    """Phase 18: ``python -m repro_torch.launch.dryrun`` of each of
    ``DRYRUN``'s cells in a subprocess under a time limit (a fake process
    group of the production mesh's 256 ranks, fake tensors: analysis, not
    speed); each record must read ``status: ok``.  Prints per-rank argument
    and temp bytes beside ``HBM_PER_GPU``, the collectives by kind and the
    roofline terms."""
    from repro_torch.launch.mesh import HBM_PER_GPU

    out = ROOT / "results" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for shape in DRYRUN["shapes"]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN["arch"],
             "--shape", shape, "--mesh", DRYRUN["mesh"], "--layers",
             str(DRYRUN["layers"]), "--out", str(out)],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=DRYRUN["timeout"])
        path = out / (f"{DRYRUN['arch']}__{shape}__{DRYRUN['mesh']}__"
                      f"L{DRYRUN['layers']}.json")
        rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        if proc.returncode or rec["status"] != "ok":
            raise SystemExit(f"dry run of {DRYRUN['arch']} x {shape}: exit "
                             f"{proc.returncode}, status {rec['status']}: "
                             f"{rec.get('traceback', proc.stderr[-3000:])}")
        mem, coll = rec["memory_analysis"], rec["collectives"]
        log(f"dry run ({card}; torch {torch.__version__}; fake group, no device "
            f"work) {DRYRUN['arch']} x {shape} x {DRYRUN['mesh']} ({rec['nchips']} "
            f"ranks) with {DRYRUN['layers']} layers, {time.perf_counter() - t0:.1f} s: "
            f"per rank arguments {mem['argument_size_bytes']} B, temp "
            f"{mem['temp_size_bytes']} B, output {mem['output_size_bytes']} B "
            f"(HBM_PER_GPU {HBM_PER_GPU} B); FLOPs {rec['hlo_flops_per_chip']:.4g}, "
            f"bytes {rec['hlo_bytes_per_chip']:.4g}; collectives "
            + ", ".join(f"{k} {coll[k]:.4g} B in {coll['n_' + k]}"
                        for k in coll if not k.startswith("n_") and coll[k])
            + f"; links {{{', '.join(f'{a}: {v['link']}' for a, v in rec['collective_links'].items())}}}"
            f"; compute {rec['compute_s']:.4g} s, memory {rec['memory_s']:.4g} s, "
            f"collective {rec['collective_s']:.4g} s: {rec['dominant']}; "
            f"model FLOPs {rec['model_flops_global']:.4g}, useful ratio "
            f"{rec['useful_flops_ratio']:.4g}")


# ---------------------------------------------------------------------------
# Phase 16: gemma3_4b and seamless_m4t_medium train.
# ---------------------------------------------------------------------------


def train16_report(cfg, recs, prof, shape: str) -> dict:
    """Phase 16's summary of one model's steps and profiled step: wall ms
    (median of the steps but the first), device busy and idle share, the
    flash backward's ms and share of busy time, peak memory (which must stay
    below the card's)."""
    wall = statistics.median(r["ms"] for r in recs[1:])
    busy, bwd = prof["busy"], prof["share_ms"]
    peak = max(r["peak_gib"] for r in recs)
    total = (torch.cuda.get_device_properties(0).total_memory / 2**30
             if torch.cuda.is_available() else float("inf"))
    losses = [r["loss"] for r in recs]
    log(f"{cfg.name} train step at {shape}: wall {wall:.1f} ms (median of the "
        f"steps but the first), device busy {busy:.1f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%), flash backward "
        f"({TRAIN16_BWD_ROUTE[cfg.name]}) {bwd:.1f} ms ({100 * bwd / busy:.1f}% of "
        f"busy); losses {losses}; peak {peak:.3f} GiB of the card's {total:.3f}")
    if not peak < total:
        raise SystemExit(f"{cfg.name} train step's peak memory does not fit the card")
    return {"wall_ms": wall, "busy_ms": busy, "bwd_ms": bwd, "peak_gib": peak,
            "launches": recs[0]["launches"]["flash_attention_bwd"]}


def gemma3_train_path(api, params, seed) -> dict:
    """Phase 16, gemma3_4b: the gradient gate on the first microbatch of
    the first batch, then ``GEMMA_TRAIN["steps"]`` steps of the in-place
    Trainer (microbatch 8; flash launches by route held to 8 x (68 forward
    and 34 backward, all on wgmma) a step) and one profiled step."""
    from repro_torch.data.pipeline import BatchSpec, TokenPipeline
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg, dev = api.cfg, api.device
    B, S, n_micro = GEMMA_TRAIN["B"], GEMMA_TRAIN["S"], GEMMA_TRAIN["microbatch"]
    route = TRAIN16_BWD_ROUTE[cfg.name]
    pipe = TokenPipeline(BatchSpec(B, S, cfg.vocab_size), seed, structured=True)
    micro0 = {k: torch.as_tensor(v[:B // n_micro]).to(dev)
              for k, v in pipe.batch_at(0).items()}
    gate = train_gate(api, params, micro0, TOL_TRAIN16_GRADS[cfg.name], route)
    del micro0
    trainer = Trainer(api, TrainConfig(warmup_steps=2, microbatch=n_micro), pipe,
                      params=params)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def run_step():
        return trainer.run(1)[-1]

    recs = counted_steps(run_step, GEMMA_TRAIN["steps"], dev,
                         flash_train_want(cfg, route, n_micro), cfg.name)
    prof = profile_train_step(run_step, dev, "flash_bwd",
                              f"flash backward ({route}, D {cfg.hd})")
    return {"gate": gate, **train16_report(
        cfg, recs, prof, f"{B} x {S} in {n_micro} microbatches")}


def seamless_train_path(api, params, gen, seed) -> dict:
    """Phase 16, seamless_m4t_medium: B 8 with seeded frames (from ``gen``:
    the reference's pipeline yields tokens and labels only) and target
    tokens from the structured stream; the gradient gate on the first
    batch, then ``SEAMLESS_TRAIN["steps"]`` steps of the in-place
    ``make_train_fn`` (flash launches by route held to 72 forward and 36
    backward, all on wgmma, a step) and one profiled step."""
    from repro_torch.data.pipeline import BatchSpec, TokenPipeline
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainConfig, make_train_fn

    cfg, dev = api.cfg, api.device
    B, S_enc, S, n = (SEAMLESS_TRAIN[k] for k in ("B", "S_enc", "S", "steps"))
    route = TRAIN16_BWD_ROUTE[cfg.name]
    pipe = TokenPipeline(BatchSpec(B, S, cfg.vocab_size), seed, structured=True)
    frames = torch.randn(n + 1, B, S_enc, cfg.d_model, generator=gen,
                         device=gen.device).to(torch.bfloat16)

    def batch_at(step):
        return {**{k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(step).items()},
                "frames": frames[step]}

    gate = train_gate(api, params, batch_at(0), TOL_TRAIN16_GRADS[cfg.name], route)
    step_fn = make_train_fn(api, TrainConfig(warmup_steps=2), donate=True)
    state = {"opt": adamw_init(params), "step": 0}

    def run_step():
        step = state["step"]
        _, state["opt"], _, metrics = step_fn(params, state["opt"], None,
                                              batch_at(step), step)
        state["step"] = step + 1
        return {"step": step, **{k: float(v) for k, v in metrics.items()}}

    recs = counted_steps(run_step, n, dev, flash_train_want(cfg, route), cfg.name)
    prof = profile_train_step(run_step, dev, "flash_bwd", f"flash backward ({route})")
    return {"gate": gate, **train16_report(
        cfg, recs, prof, f"{B} x {S} tokens over {S_enc} frames")}


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
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.ssm_scan.kernel import gla_scan_cuda
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
        f"x{torch.cuda.device_count()}, total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} bytes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    # 2. build
    t0 = time.perf_counter()
    report = _build.build(["flash_attention", "flash_attention_wgmma",
                           "flash_attention_bwd", "flash_attention_bwd_wgmma",
                           "paged_attention", "paged_attention_split",
                           "decode_attention_split",
                           "gla_scan", "gla_scan_mma", "gla_scan_bwd",
                           "gla_scan_bwd_mma"])
    log(f"build: {time.perf_counter() - t0:.1f} s wall into {_build.BUILD_DIR} "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in report.items()))
    for k, v in report.items():
        if k.startswith("gla_scan_bwd"):   # by gla_bwd_ptxas
            continue
        for line in v["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "arning")):
                log(f"  {k}: {line.strip()}")
    hgmma = sass_count(_build.lib_path("flash_attention_wgmma"), "HGMMA")
    hgmma_320 = sass_count(_build.lib_path("flash_attention_wgmma"), "HGMMA",
                           "Li320E")
    log(f"SASS of flash_attention_wgmma: {hgmma} HGMMA instructions, "
        f"{hgmma_320} of them in the D 320 instance")
    if hgmma == 0 or hgmma_320 == 0:
        raise SystemExit("the bf16 flash library (or its D 320 instance) has "
                         "no tensor-core (HGMMA) instruction")
    for lib in ("flash_attention_wgmma", "flash_attention"):
        lines = (ptxas_lines(report[lib]["ptxas"], "Li320E") if lib in report
                 else ["built before this run: no ptxas output"])
        log(f"ptxas -v, D 320 instance of {lib}: " + "; ".join(lines))
    check_bwd_sass(report)
    gla_bwd_ptxas(report)
    for lib in ("gla_scan_mma", "gla_scan_bwd_mma"):
        hmma = sass_count(_build.lib_path(lib), "HMMA")
        log(f"SASS of {lib}: {hmma} HMMA instructions")
        if hmma == 0:
            raise SystemExit(f"the bf16 gla_scan library {lib} has no tensor-core "
                             "(HMMA) instruction")

    # 3. kernels against plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    flash = check_flash(gen, timer, args.seed)
    paged_row = check_paged(gen, timer, args.seed)
    decode_rows = check_decode(timer, args.seed)
    gla_row = check_gla(gen, timer)
    flash_bwd = check_flash_bwd(timer, args.seed)
    gla_bwd = check_gla_bwd(timer, args.seed)
    del timer
    for arch in ("tinyllama_1p1b",) + MOE_ARCHS + ("qwen2_vl_72b",) + DENSE_ARCHS:
        check_reduced_against_cpu(arch, args.seed)
    for arch in ("tinyllama_1p1b", MOE_ARCHS[0], "rwkv6_7b", "zamba2_1p2b",
                 "gemma3_4b", "seamless_m4t_medium", "qwen2_vl_72b"):
        check_reduced_grads_against_cpu(arch, args.seed)
    for arch in ("rwkv6_7b", "zamba2_1p2b", "seamless_m4t_medium", "gemma3_4b"):
        check_reduced_api_against_cpu(arch, args.seed)

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
    tiny_counts = main["counts"]
    pool_pages = main["paged"]["block_table"][0].tolist()   # sequence 0
    kv = kv_paging(main["paged"], [(l, p) for l in range(3) for p in pool_pages],
                   hbm_blocks=8)
    log(f"kv paging: {kv['spills']} K pages of {kv['page_bytes']} bytes spilled "
        f"to the page store, {kv['fetches']} fetched back bit-exact, "
        f"{kv['offloaded']} offloaded reads")
    # phase 17 serves these weights again, held to this phase's logits
    tiny = {"params": tree_to(params, "cpu"), "tokens": main["tokens"],
            "prefill_logits": main["prefill_logits"],
            "dense_logits": main["dense_logits"],
            "dense_graph_ms": main["dense_graph_ms"]}
    del api, params, main
    torch.cuda.empty_cache()

    # 7-8. the gated-linear-attention family at full width and depth
    counts = {}
    for arch in ("rwkv6_7b", "zamba2_1p2b"):
        torch.cuda.reset_peak_memory_stats()
        api = build_model(get_config(arch))
        params, _ = api.init(gen)
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        counts[arch] = ssm_path(api, params, gen, gla_scan_cuda,
                                flash_attention_cuda)
        log(f"{arch}: peak device memory {init_peak:.3f} GiB during init, "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during "
            "prefill and decode")
        serve_batch(api, params, f"{name} ({card})")
        del api, params
        torch.cuda.empty_cache()

    # 9-10. the MoE family: granite at full width and depth, dbrx at full
    # width and reduced depth
    for arch in MOE_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        if arch == "dbrx_132b":
            log(f"dbrx_132b: {DBRX_LAYERS} of its {cfg.num_layers} layers at "
                "full width (bf16 weights of all 40 are about 264 GB)")
            cfg = dataclasses.replace(cfg, num_layers=DBRX_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        api = build_model(cfg)
        params, _ = api.init(gen)
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        moe = main_path(api, params, gen, flash_attention_cuda,
                        paged_attention_cuda)
        log(f"{arch}: launches {moe['counts']}; weights "
            f"{weights_ms(params) * H100_BYTES_PER_S / 1e12:.3f} GB; peak "
            f"device memory {init_peak:.3f} GiB during init, "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during "
            "prefill and decode")
        del moe
        if arch == "granite_moe_3b_a800m":
            serve_batch(api, params, f"{name} ({card})")
        del api, params
        torch.cuda.empty_cache()
        log(f"{arch} phase {time.perf_counter() - t_phase:.1f} s")

    # 11. the encoder-decoder at full width and depth
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    api = build_model(get_config("seamless_m4t_medium"))
    params, _ = api.init(gen)
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    seamless_path(api, params, gen, flash_attention_cuda, **SEAMLESS)
    log(f"seamless_m4t_medium: weights {weights_ms(params) * H100_BYTES_PER_S / 1e12:.3f} "
        f"GB; peak device memory {init_peak:.3f} GiB during init, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during encode, "
        "prefill and decode")
    serve_batch(api, params, f"{name} ({card})")
    del api, params
    torch.cuda.empty_cache()
    log(f"seamless_m4t_medium phase {time.perf_counter() - t_phase:.1f} s")

    # 12. local:global attention at full width and depth
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    api = build_model(get_config("gemma3_4b"))
    params, _ = api.init(gen)
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    gemma3_path(api, params, gen, flash_attention_cuda, **GEMMA)
    log(f"gemma3_4b: weights {weights_ms(params) * H100_BYTES_PER_S / 1e12:.3f} "
        f"GB; peak device memory {init_peak:.3f} GiB during init, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during prefill "
        "and decode")
    serve_batch(api, params, f"{name} ({card})")
    del api, params
    torch.cuda.empty_cache()
    log(f"gemma3_4b phase {time.perf_counter() - t_phase:.1f} s")

    # 13. the vlm family at full width and reduced depth
    t_phase = time.perf_counter()
    cfg = get_config("qwen2_vl_72b")
    log(f"qwen2_vl_72b: {VLM_LAYERS} of its {cfg.num_layers} layers at full "
        "width (bf16 weights of all 80 are about 145 GB)")
    cfg = dataclasses.replace(cfg, num_layers=VLM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    api = build_model(cfg)
    params, _ = api.init(gen)
    init_peak = torch.cuda.max_memory_allocated()
    weights = weights_ms(params) * H100_BYTES_PER_S / 1e3
    layer = weights_ms(params["blocks"]) * H100_BYTES_PER_S / 1e3 / cfg.num_layers
    log(f"qwen2_vl_72b: weights {weights / 1e9:.3f} GB ({layer / 1e9:.3f} GB a "
        f"layer); peak device memory during init {init_peak / 2**30:.3f} GiB "
        f"(weights + one layer {(weights + layer) / 2**30:.3f} GiB)")
    if init_peak > weights + layer + INIT_SLACK:
        raise SystemExit("qwen2_vl_72b init held more than its weights, one "
                         "layer and the slack of drawing one matrix")
    torch.cuda.reset_peak_memory_stats()
    vlm = vlm_path(api, params, gen, flash_attention_cuda, paged_attention_cuda,
                   **VLM)
    log(f"qwen2_vl_72b: launches {vlm['counts']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during prefill, "
        "decode and the continuation test")
    serve_batch(api, params, f"{name} ({card})")
    pool_pages = vlm["paged"]["block_table"][0].tolist()     # sequence 0
    kv = kv_paging(vlm["paged"], [(l, p) for l in range(3) for p in pool_pages],
                   hbm_blocks=8)
    log(f"qwen2_vl_72b kv paging: {kv['spills']} K pages of {kv['page_bytes']} "
        f"bytes ({kv['parts']} store pages each) spilled to the page store, "
        f"{kv['fetches']} fetched back bit-exact, {kv['offloaded']} offloaded "
        "reads")
    vlm_counts = vlm["counts"]
    del api, params, vlm
    torch.cuda.empty_cache()
    log(f"qwen2_vl_72b phase {time.perf_counter() - t_phase:.1f} s")

    # 14. training and DDS checkpoints at full width and depth
    t_phase = time.perf_counter()
    api = build_model(get_config("tinyllama_1p1b"))
    params, _ = api.init(gen)
    train = train_path(api, params, gen, args.seed, flash_attention_cuda,
                       flash_attention_bwd_cuda)
    del api, params
    torch.cuda.empty_cache()
    log(f"tinyllama_1p1b training phase {time.perf_counter() - t_phase:.1f} s")

    # 15. the gated-linear-attention family trains at full width, from a
    # generator of its own (the gate's limits are readings at its draw)
    ssm_train = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for arch in ("zamba2_1p2b", "rwkv6_7b"):
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        if arch == "rwkv6_7b":
            log(f"rwkv6_7b: {RWKV6_TRAIN_LAYERS} of its {cfg.num_layers} layers at "
                "full width for training (bf16 weights and gradients and fp32 "
                "moments of all 32 are about 90 GB)")
            cfg = dataclasses.replace(cfg, num_layers=RWKV6_TRAIN_LAYERS)
        api = build_model(cfg)
        params, _ = api.init(gen)
        log(f"{arch}: weights {weights_ms(params) * H100_BYTES_PER_S / 1e12:.3f} GB")
        ssm_train[arch] = ssm_train_path(api, params, args.seed)
        del api, params
        torch.cuda.empty_cache()
        log(f"{arch} training phase {time.perf_counter() - t_phase:.1f} s")

    # 16. gemma3_4b and seamless_m4t_medium train at full width and depth,
    # from a generator of their own (the gate's limits are readings at its
    # draw)
    train16 = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for arch in ("gemma3_4b", "seamless_m4t_medium"):
        t_phase = time.perf_counter()
        api = build_model(get_config(arch))
        params, _ = api.init(gen)
        log(f"{arch}: weights {weights_ms(params) * H100_BYTES_PER_S / 1e12:.3f} GB")
        train16[arch] = (gemma3_train_path(api, params, args.seed)
                         if arch == "gemma3_4b" else
                         seamless_train_path(api, params, gen, args.seed))
        del api, params
        torch.cuda.empty_cache()
        log(f"{arch} training phase {time.perf_counter() - t_phase:.1f} s")

    # 17. the sharded entry points on a 1 x 1 NCCL mesh
    t_phase = time.perf_counter()
    sharded_path(tiny, train, args.seed, flash_attention_cuda,
                 flash_attention_bwd_cuda, card)
    log(f"sharded phase {time.perf_counter() - t_phase:.1f} s")

    # 18. the dry run on a fake process group, in processes of its own
    t_phase = time.perf_counter()
    dryrun_path(card)
    log(f"dry-run phase {time.perf_counter() - t_phase:.1f} s")

    # 19-20. qwen2p5_14b and starcoder2_7b at full width and depth, each
    # from a generator of its own (the limits are readings at its draw)
    dense_counts = {}
    for arch in DENSE_ARCHS:
        t_phase = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        torch.cuda.reset_peak_memory_stats()
        api = build_model(get_config(arch))
        params, _ = api.init(gen)
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        dense_counts[arch] = dense_path(api, params, gen, flash_attention_cuda,
                                        paged_attention_cuda)["counts"]
        log(f"{arch}: launches {dense_counts[arch]}; peak device memory "
            f"{init_peak:.3f} GiB during init, "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during "
            "prefill, decode and the readings")
        serve_batch(api, params, f"{name} ({card})")
        del api, params
        torch.cuda.empty_cache()
        log(f"{arch} phase {time.perf_counter() - t_phase:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    entries = []
    # name, timed row, main-path launches, source, TPU kernel.  The kernel
    # route is the one the timed case was asserted to take; the last two are
    # the same kernels at qwen2_vl_72b's heads, with phase 13's launches.
    for kname, row, launches, source, line in (
            ("flash_attention", flash["main"], tiny_counts["flash_attention"],
             "flash_attention_wgmma", "src/repro/kernels/flash_attention/kernel.py:96"),
            ("paged_attention", paged_row["main"], tiny_counts["paged_attention"],
             "paged_attention_split", "src/repro/kernels/paged_attention/kernel.py:84"),
            ("gla_scan", gla_row, counts["rwkv6_7b"]["gla_scan"],
             "gla_scan_mma", "src/repro/kernels/ssm_scan/kernel.py:76"),
            ("flash_attention@qwen2_vl_72b", flash["qwen2_vl_72b"],
             vlm_counts["flash_attention"], "flash_attention_wgmma",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            ("paged_attention@qwen2_vl_72b", paged_row["qwen2_vl_72b"],
             vlm_counts["paged_attention"], "paged_attention_split",
             "src/repro/kernels/paged_attention/kernel.py:84"),
            # the gradient of the Pallas forward (the JAX package has no
            # Pallas backward); wgmma launches of phase 14's uninterrupted run
            ("flash_attention_bwd", flash_bwd["tinyllama_1p1b training"],
             train["launches"]["flash_attention_bwd"]["wgmma"],
             "flash_attention_bwd_wgmma",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            # the gradient of the Pallas forward, likewise; launches of phase
            # 15's rwkv6_7b steps
            ("gla_scan_bwd", gla_bwd["rwkv6_7b training"], ssm_train["rwkv6_7b"]["launches"],
             "gla_scan_bwd_mma", "src/repro/kernels/ssm_scan/kernel.py:76"),
            # the flash backward at gemma3_4b's D 320 (two consumer
            # warpgroups); launches of one phase 16 step (8 microbatches of
            # 34 layers)
            ("flash_attention_bwd@gemma3_4b", flash_bwd["gemma3_4b training, local layers"],
             train16["gemma3_4b"]["launches"]["wgmma"], "flash_attention_bwd_wgmma",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            # the forward kernels at G 5 and G 9 (D 128), with phases 19-20's
            # launches; the dense decode attention (no TPU kernel: the plain
            # jnp body) at the benchmark cells' shapes, with the launches of
            # phases 19-20's eager dense steps
            *((f"{kernel}@{arch}", row[arch], dense_counts[arch][kernel], source, line)
              for arch in DENSE_ARCHS
              for kernel, row, source, line in (
                  ("flash_attention", flash, "flash_attention_wgmma",
                   "src/repro/kernels/flash_attention/kernel.py:96"),
                  ("paged_attention", paged_row, "paged_attention_split",
                   "src/repro/kernels/paged_attention/kernel.py:84"),
                  ("decode_attention", decode_rows, "decode_attention_split",
                   "none: src/repro/models/layers.py::_decode_attend")))):
        entries.append({
            "name": kname, "route": "cuda", "case": str(row["case"]),
            "kernel_route": row["route"][0],
            "source": f"src/repro_torch/csrc/{source}.cu", "replaces": line,
            "launches": launches, "max_abs_err": row.get("abs_err", row["err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
