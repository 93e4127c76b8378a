"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card.  These tests need CUDA and skip without it; they import no JAX,
so they run on the card's machine:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

The dense decode attention kernel is held to its plain body
(``decode_attention_ref``) at the same attention tolerances, and in bf16
from 1000 live positions on at 2e-3, where its outputs are small.  Inputs and
tolerances are those of ``test_torch_kernels.py`` and
``test_torch_ssm_scan.py`` (``_torch_cases.py``): 2e-5 for fp32 and 2e-2
for bf16 on attention; four times that on the GLA scan's output and 1e-3
on its final state, as the JAX package's GLA tests.  The flash backward's
gradients vary in scale, so its tolerances (the same 2e-5 and 2e-2) are
relative to the largest |gradient| of each output; so are the GLA
backward's (1e-4 in fp32, 2e-2 in bf16) against ``gla_scan_bwd_ref``, on
both of its routes (bf16 at K = V = 64 on the tensor cores, where dw, fp32,
is also held to 1e-4).
"""

import numpy as np
import pytest
import torch

from _torch_cases import (FA_BWD_CASES, FA_CASES, FA_GEMMA_CASES, FA_MOE_CASES,
                          FA_VLM_CASES, GLA_CASES, GLA_MMA_CASES,
                          PA_CASES, PA_SPLIT_CASES, TOL, fa_bwd_inputs, fa_inputs,
                          gla_exact_bound_inputs, gla_inputs, gla_mma_inputs,
                          pa_inputs, pa_split_inputs)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (bwd_route,
                                                        flash_attention_bwd_cuda,
                                                        flash_attention_cuda,
                                                        flash_attention_fwd_cuda)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssm_scan import gla_scan
from repro_torch.kernels.ssm_scan.kernel import _BWD_LIBS as GLA_BWD_LIBS
from repro_torch.kernels.ssm_scan.kernel import bwd_route as bwd_route_gla
from repro_torch.kernels.ssm_scan.kernel import gla_scan_bwd_cuda, gla_scan_cuda
from repro_torch.kernels.ssm_scan.ops import gla_scan_xla
from repro_torch.kernels.ssm_scan.ref import gla_scan_bwd_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(a: np.ndarray, device, dtype=None):
    t = torch.from_numpy(a).to(device)
    return t.to(DTYPES[dtype]) if dtype else t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


ROUTE = {"float32": "simt", "bfloat16": "wgmma"}


def _flash_close(case, dtype, device, q_offset=None):
    """The kernel against attention_ref on fa_inputs(case), and the launch
    counted on the route the dtype names (bf16: tensor cores, fp32: CUDA
    cores)."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = case
    tq, tk, tv = (_on(a, device, dtype) for a in fa_inputs(case))
    before = dict(flash_attention_cuda.launches_by_route)
    out = flash_attention_cuda(tq, tk, tv, causal=causal, window=window,
                               q_offset=q_offset)
    torch.cuda.synchronize()
    after = flash_attention_cuda.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == ROUTE[dtype]) for r in after}
    ref = attention_ref(tq, tk, tv, causal=causal, window=window,
                        q_offset=q_offset)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_cuda_matches_plain(case, dtype, cuda_device):
    _flash_close(case, dtype, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_MOE_CASES)
def test_flash_attention_cuda_at_moe_heads(case, dtype, cuda_device):
    """granite-MoE's G = 3 at D 64 and DBRX's G = 6 at D 128."""
    _flash_close(case, dtype, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_VLM_CASES)
def test_flash_attention_cuda_at_vlm_heads(case, dtype, cuda_device):
    """qwen2_vl_72b's G 8 at D 128: 64-row query tiles of eight heads over
    one K/V head, two 64-column TMA boxes."""
    _flash_close(case, dtype, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_GEMMA_CASES)
def test_flash_attention_cuda_at_head_dim_320(case, dtype, cuda_device):
    """gemma3_4b's D 320 (five 64-column TMA boxes and five P V products a
    key step on wgmma; 16-key tiles and eight threads a row on the CUDA
    cores), windowed and not, ragged, and at Sq < Sk."""
    _flash_close(case, dtype, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 512, 512, 4, 4, 64, True, None),
                                  (1, 500, 500, 4, 4, 64, True, None)])
def test_flash_attention_cuda_one_query_head_per_kv_head(case, dtype,
                                                         cuda_device):
    """G = 1 (Zamba2's shared attention block) at S 512: the fp32 kernel
    gives each block 64 positions of one head, so its causal tile skip runs
    at a coarser grain than at TinyLlama's G = 8."""
    _flash_close(case, dtype, cuda_device)


# B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset
FA_EDGE_CASES = [
    (2, 77, 77, 6, 2, 64, True, None, None),      # ragged S, G = 3
    (1, 64, 192, 8, 2, 64, True, None, None),     # Sq < Sk: q_offset 128
    (1, 64, 192, 8, 2, 64, True, None, 37),       # q_offset off the tile grid
    (1, 100, 300, 4, 2, 64, False, None, None),   # non-causal, Sq != Sk
    (1, 128, 128, 8, 1, 128, True, None, None),   # D 128 at G 8
    (1, 200, 200, 4, 4, 32, True, 50, None),      # window at D 32
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_EDGE_CASES)
def test_flash_attention_cuda_edge_shapes(case, dtype, cuda_device):
    """Shapes off the 64-row and 64-key tile grids, an explicit q_offset,
    cross-attention without a mask, D 128 (two TMA column boxes) and a
    window at D 32 (the 64-byte swizzle)."""
    _flash_close(case[:-1], dtype, cuda_device, q_offset=case[-1])


# ---------------------------------------------------------------------------
# Flash backward: the kernel against attention_bwd_ref on the same inputs,
# max |err| of each gradient over its largest |value|, on the route
# bwd_route names (bf16: the tensor cores, at D 320 with dK and dV on two
# warpgroups; fp32: the CUDA cores).
# ---------------------------------------------------------------------------


def _bwd_inputs(case, device, dtype, seed=6):
    q, k, v, do = (_on(a, device, dtype) for a in fa_bwd_inputs(case, seed))
    B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o = attention_ref(q, k, v, **kw)
    return q, k, v, o, do, kw


def _bwd_routed(case, dtype, call):
    """``call()``'s result, asserting that it made one backward launch, on
    the route ``bwd_route`` names for the case's dtype and head dim."""
    want = bwd_route(DTYPES[dtype], case[5])
    before = dict(flash_attention_bwd_cuda.launches_by_route)
    out = call()
    torch.cuda.synchronize()
    after = flash_attention_bwd_cuda.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == want) for r in after}
    return out


def _grads_close(got, ref, tol):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        scale = max(r.float().abs().max().item(), 1e-30)
        err = (g.float() - r.float()).abs().max().item() / scale
        assert err <= tol, f"{name}: {err:.3e} of max |grad| > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_flash_attention_bwd_cuda_matches_plain(case, dtype, cuda_device):
    """Within tolerance of the plain version on the route the rule names,
    and two calls bit-equal (no atomics)."""
    q, k, v, o, do, kw = _bwd_inputs(case, cuda_device, dtype)
    before = flash_attention_bwd_cuda.launches
    got = _bwd_routed(case, dtype, lambda: flash_attention_bwd_cuda(q, k, v, o, do, **kw))
    assert flash_attention_bwd_cuda.launches == before + 1
    _grads_close(got, attention_bwd_ref(q, k, v, o, do, **kw), TOL[dtype])
    again = flash_attention_bwd_cuda(q, k, v, o, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_cuda_is_deterministic(dtype, cuda_device):
    """No atomics and a fixed order: two calls give the same bits."""
    q, k, v, o, do, kw = _bwd_inputs(FA_BWD_CASES[1], cuda_device, dtype)
    a = flash_attention_bwd_cuda(q, k, v, o, do, **kw)
    b = flash_attention_bwd_cuda(q, k, v, o, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset: rows that see no key
# (every row: a window behind a large q_offset; some rows: the same window
# nearer, also at D 320, or causal rows before the first key at a negative
# q_offset).
FA_BWD_MASKED_CASES = [
    (1, 64, 64, 4, 2, 64, True, 16, 100),
    (1, 64, 64, 4, 2, 64, True, 16, 40),
    (1, 64, 64, 4, 2, 320, True, 16, 40),
    (2, 64, 32, 8, 1, 64, True, None, -16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_BWD_MASKED_CASES)
def test_flash_attention_bwd_cuda_masked_rows_give_zero(case, dtype, cuda_device):
    """A row whose keys are all masked gets zero gradients, not NaN."""
    q, k, v, o, do, kw = _bwd_inputs(case, cuda_device, dtype)
    got = _bwd_routed(case, dtype, lambda: flash_attention_bwd_cuda(q, k, v, o, do, **kw))
    _grads_close(got, attention_bwd_ref(q, k, v, o, do, **kw), TOL[dtype])
    Sq, Sk, window, q_offset = case[1], case[2], case[7], case[8]
    qpos = torch.arange(Sq, device=cuda_device) + q_offset
    sees = (qpos >= 0) & (qpos - (window or Sk + abs(q_offset)) < Sk - 1)
    assert not bool(sees.all())
    assert bool((got[0][:, ~sees] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_autograd_goes_through_the_kernels(dtype, cuda_device):
    """The dispatcher's cuda path under autograd: one forward and one
    backward launch (the backward on its route, reading the forward's lse
    on the wgmma route), gradients as attention_bwd_ref's; under no_grad the
    forward launch alone."""
    case = FA_BWD_CASES[0]
    q, k, v, o, do, kw = _bwd_inputs(case, cuda_device, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches

    def forward_and_backward():
        out = flash_attention(*leaves, **kw)
        out.backward(do)
        return out

    out = _bwd_routed(case, dtype, forward_and_backward)
    assert (flash_attention_cuda.launches - fwd,
            flash_attention_bwd_cuda.launches - bwd) == (1, 1)
    ref = attention_bwd_ref(q, k, v, out.detach(), do, **kw)
    _grads_close([t.grad for t in leaves], ref, TOL[dtype])
    with torch.no_grad():
        flash_attention(*leaves, **kw)
    assert flash_attention_bwd_cuda.launches - bwd == 1


def _plain_lse(q, k, *, causal, window, q_offset):
    """Each row's log-sum-exp of the scaled, masked logits in fp32: (B, Hq,
    Sq)."""
    B, Sq, Hq, D = q.shape
    Sk, G = k.shape[1], Hq // k.shape[2]
    if q_offset is None:
        q_offset = Sk - Sq
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=2)) * D ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return torch.where(mask, s, torch.full_like(s, -torch.inf)).logsumexp(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in FA_BWD_CASES if c[5] <= 128])
def test_flash_attention_fwd_lse(case, cuda_device):
    """The wgmma forward's optional log-sum-exp output: the output is the
    same bits with it and without it, and the lse is within 1e-4 of
    max(|lse|, 1) of the plain one; a backward handed that lse gives the
    bits of one that launches the forward itself."""
    q, k, v, o, do, kw = _bwd_inputs(case, cuda_device, "bfloat16")
    plain_out, none = flash_attention_fwd_cuda(q, k, v, **kw)
    out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    ref = _plain_lse(q, k, **kw)
    err = ((lse - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    assert err <= 1e-4, err
    given = flash_attention_bwd_cuda(q, k, v, out, do, lse=lse, **kw)
    fetched = flash_attention_bwd_cuda(q, k, v, out, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(given, fetched))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PA_CASES)
def test_paged_attention_cuda_matches_plain(case, dtype, cuda_device):
    q, kp, vp, bt, sl = pa_inputs(case)
    tq, tk, tv = (_on(a, cuda_device, dtype) for a in (q, kp, vp))
    tbt, tsl = _on(bt, cuda_device), _on(sl, cuda_device)
    out = paged_attention_cuda(tq, tk, tv, tbt, tsl)
    torch.cuda.synchronize()
    ref = paged_attention_ref(tq, tk, tv, tbt, tsl)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
def test_paged_attention_cuda_zero_length_gives_zeros(cuda_device):
    """seq_len == 0: zeros, as the Pallas kernel (the ref gives mean(V))."""
    q, kp, vp, bt, _ = pa_inputs(PA_CASES[0])
    tq, tk, tv, tbt = (_on(a, cuda_device) for a in (q, kp, vp, bt))
    out = paged_attention_cuda(tq, tk, tv, tbt,
                               torch.zeros(q.shape[0], dtype=torch.int32,
                                           device=cuda_device))
    assert torch.count_nonzero(out).item() == 0


def _paged_routed(want, *args, **kw):
    """paged_attention_cuda, with the launch counted on route ``want``
    alone."""
    before = dict(paged_attention_cuda.launches_by_route)
    out = paged_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    after = paged_attention_cuda.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == want) for r in after}
    return out


def _split_on(case, device, dtype):
    q, kp, vp, bt, sl = pa_split_inputs(case)
    return (*(_on(a, device, dtype) for a in (q, kp, vp)), _on(bt, device),
            _on(sl, device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PA_SPLIT_CASES)
def test_paged_attention_cuda_split_route_matches_plain(case, dtype,
                                                        cuda_device):
    """The cluster-split kernel at G 1, 3, 5, 6, 8, 9, D 64 and 128 (G 8 at
    D 128: qwen2_vl_72b's heads, page 128, over a nine-page table), pages 16
    and 128, with lengths on both sides of the page and split boundaries
    (1, page +- 1, C * page +- 1, max_pages * page) and a table wider than
    the pages used."""
    args = _split_on(case, cuda_device, dtype)
    out = _paged_routed("split", *args)
    ref = paged_attention_ref(*args)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_cuda_split_never_reads_unused_table_entries(
        dtype, cuda_device):
    """Entries past ceil(seq_len / page) poisoned with -1 and P + 7 give the
    same output as the clean table: they are never read."""
    q, kp, vp, bt, sl = _split_on(PA_SPLIT_CASES[6], cuda_device, dtype)
    page, P = kp.shape[1], kp.shape[0]
    used = (sl + page - 1) // page
    past = torch.arange(bt.shape[1], device=cuda_device)[None, :] >= used[:, None]
    poisoned = bt.clone()
    poisoned[past] = torch.where(
        torch.arange(int(past.sum()), device=cuda_device) % 2 == 0, -1, P + 7
    ).int()
    assert (poisoned != bt).any()
    clean = _paged_routed("split", q, kp, vp, bt, sl)
    out = _paged_routed("split", q, kp, vp, poisoned, sl)
    assert torch.equal(out, clean)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_cuda_split_zero_length_gives_zeros(dtype,
                                                            cuda_device):
    """seq_len == 0 on the split route: zeros for that sequence, as the
    Pallas kernel; the others as the plain version."""
    q, kp, vp, bt, sl = _split_on(PA_SPLIT_CASES[3], cuda_device, dtype)
    sl[1] = 0
    out = _paged_routed("split", q, kp, vp, bt, sl)
    assert torch.count_nonzero(out[1]).item() == 0
    keep = torch.tensor([0, 2], device=cuda_device)
    ref = paged_attention_ref(q[keep], kp, vp, bt[keep], sl[keep])
    np.testing.assert_allclose(_np(out[keep]), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# Dense decode attention: the split kernel against the plain body (the
# attention tolerances above).
# ---------------------------------------------------------------------------

# B, S_cache, Hkv, G, D, valid lengths: lengths on both sides of a unit
# (16) and of the cluster's split (C = 8 units), one short of the cache and
# the full cache; caches that are not a multiple of 16 and a window ring
# shorter than a unit; the benchmark cells' shapes (StarCoder2-7B's B 32,
# cache 3904, 36/4 heads of 128; Qwen2.5-14B's B 4, cache 4128, 40/8).
DA_CASES = [
    (3, 100, 2, 3, 64, (1, 15, 16, 17, 33, 99, 100)),
    (2, 300, 4, 8, 64, (1, 129, 299, 300)),
    (2, 4, 2, 4, 128, (1, 3, 4)),
    (2, 200, 1, 1, 64, (17, 200)),
    (4, 4128, 8, 5, 128, (1, 17, 4127, 4128)),
    (32, 3904, 4, 9, 128, (1, 17, 3903, 3904)),
]


def _da_inputs(case, dtype, device, seed=3):
    B, S, Hkv, G, D, _ = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(*shape, generator=g).to(device, DTYPES[dtype])
               for shape in ((B, 1, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    return q, k, v


# bf16 from 1000 live positions on: a typical output is about 0.02 at
# 3903-4128 (randn q/k/v, D 128), so TOL's 2e-2 would pass a kernel that
# skipped or read twice one 16-position unit (0.011 or more); an H100
# measured 4.9e-4.  chip_smoke.py's TOL_PAGED_LONG and LONG_DECODE.
DA_TOL_LONG, DA_LONG = 2e-3, 1000


def _da_tol(dtype, n):
    return DA_TOL_LONG if dtype == "bfloat16" and n >= DA_LONG else TOL[dtype]


def _da_routed(q, k, v, valid):
    """The dispatcher, with one launch counted on the split route."""
    before = decode_attention_cuda.launches_by_route["split"]
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches_by_route["split"] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DA_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_decode_attention_cuda_matches_plain(case, dtype, cuda_device):
    q, k, v = _da_inputs(case, dtype, cuda_device)
    for n in case[5]:
        valid = torch.tensor(n, dtype=torch.int32, device=cuda_device)
        out = _da_routed(q, k, v, valid)
        ref = decode_attention_ref(q, k, v, valid)
        assert out.dtype == q.dtype and out.shape == q.shape
        tol = _da_tol(dtype, n)
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol,
                                   err_msg=f"valid {n}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cuda_never_reads_past_valid(dtype, cuda_device):
    """Positions at or past valid filled with NaN give the bits of the clean
    cache: they are never read."""
    case = DA_CASES[1]
    q, k, v = _da_inputs(case, dtype, cuda_device)
    for n in (1, 17, 129, 299):
        valid = torch.tensor(n, dtype=torch.int32, device=cuda_device)
        clean = _da_routed(q, k, v, valid)
        kp, vp = k.clone(), v.clone()
        kp[:, n:] = float("nan")
        vp[:, n:] = float("nan")
        assert torch.equal(_da_routed(q, kp, vp, valid), clean)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cuda_zero_valid_gives_zeros(dtype, cuda_device):
    """valid == 0: zeros, as the paged kernel at seq_len 0 (the plain body
    gives the mean of V; the models never call it so)."""
    q, k, v = _da_inputs(DA_CASES[0], dtype, cuda_device)
    B, _, H, D = q.shape
    out = decode_attention_cuda(q.view(B, H, D), k, v,
                                torch.zeros((), dtype=torch.int32, device=cuda_device))
    assert torch.count_nonzero(out).item() == 0


@pytest.mark.gpu
def test_decode_attention_dispatcher_keeps_the_plain_body_for_other_calls(
        cuda_device):
    """D 320 (gemma3_4b), G 10 and a misaligned q go to the plain body: no
    launch."""
    valid = torch.tensor(7, dtype=torch.int32, device=cuda_device)
    calls = [_da_inputs((2, 32, 2, 2, 320, ()), "bfloat16", cuda_device),
             _da_inputs((2, 32, 1, 10, 64, ()), "bfloat16", cuda_device)]
    q, k, v = _da_inputs((2, 32, 2, 4, 64, ()), "bfloat16", cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    calls.append((shifted, k, v))
    before = decode_attention_cuda.launches
    for args in calls:
        out = decode_attention(*args, valid)
        assert torch.equal(out, decode_attention_ref(*args, valid))
    assert decode_attention_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cuda_replays_at_other_lengths(dtype, cuda_device):
    """One capture in a CUDA graph, replayed with valid set to two lengths
    on the device: each replay equals an eager call at that length, bit for
    bit, and replays count no launch."""
    q, k, v = _da_inputs(DA_CASES[1], dtype, cuda_device)
    valid = torch.tensor(300, dtype=torch.int32, device=cuda_device)
    _da_routed(q, k, v, valid)                 # the library built and set up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, valid)
    launches = decode_attention_cuda.launches
    for n in (37, 283):
        valid.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        want = decode_attention(q, k, v, torch.tensor(n, dtype=torch.int32,
                                                      device=cuda_device))
        assert torch.equal(out, want), n
    assert decode_attention_cuda.launches == launches + 2     # the eager calls


# ---------------------------------------------------------------------------
# GLA scan: the kernel against gla_scan_xla (atol = rtol = 4 x TOL on o and
# 1e-3 on the final state, as tests/test_kernels.py::test_gla_xla_chunked).
# ---------------------------------------------------------------------------


def _gla_close(got, ref, dtype):
    (o, s), (ro, rs) = got, ref
    assert o.dtype == ro.dtype and s.dtype == torch.float32
    assert torch.isfinite(o.float()).all() and torch.isfinite(s).all()
    tol = 4 * TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(ro), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(s), _np(rs), atol=1e-3, rtol=1e-3)


def _gla_routed(q, k, v, w, chunk, want):
    """gla_scan_cuda, with the launch counted on route ``want`` alone."""
    before = dict(gla_scan_cuda.launches_by_route)
    got = gla_scan_cuda(q, k, v, w, chunk=chunk)
    torch.cuda.synchronize()
    after = gla_scan_cuda.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == want) for r in after}
    return got


# GLA_CASES plus a ragged S (200 over chunks of 64) and S below one chunk
# with V 128 (two V tiles), each with the route it takes: bf16 at K = V = 64
# and C % 16 == 0 on the tensor cores, everything else on CUDA cores.
GLA_GPU_CASES = [
    (GLA_CASES[0], "float32", "simt"), (GLA_CASES[0], "bfloat16", "mma"),
    (GLA_CASES[1], "float32", "simt"), (GLA_CASES[1], "bfloat16", "simt"),
    (GLA_CASES[2], "float32", "simt"), (GLA_CASES[2], "bfloat16", "simt"),
    (GLA_CASES[3], "float32", "simt"), (GLA_CASES[3], "bfloat16", "simt"),
    ((2, 2, 200, 64, 64, 64), "float32", "simt"),
    ((2, 2, 200, 64, 64, 64), "bfloat16", "mma"),
    ((1, 2, 37, 32, 128, 128), "float32", "simt"),
    ((1, 2, 37, 32, 128, 128), "bfloat16", "simt"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype,route", GLA_GPU_CASES)
def test_gla_scan_cuda_matches_plain(case, dtype, route, cuda_device):
    chunk = case[-1]
    q, k, v, w = gla_inputs(case)
    tq, tk, tv = (_on(a, cuda_device, dtype) for a in (q, k, v))
    tw = _on(w, cuda_device)
    got = _gla_routed(tq, tk, tv, tw, chunk, route)
    _gla_close(got, gla_scan_xla(tq, tk, tv, tw, chunk=chunk), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GLA_MMA_CASES)
def test_gla_scan_cuda_mma_route_matches_plain(case, cuda_device):
    """The tensor-core route: chunks 32, 64 and 128, a ragged S, chunks of
    three and of one query tile, the models' head-transposed q/k/v views,
    Mamba2's stride-0 w, and strong decay."""
    B, H, S, chunk, layout, decay = case
    q, k, v, w = gla_mma_inputs(case)
    if layout == "transposed":
        tq, tk, tv = (_on(a, cuda_device, "bfloat16").transpose(1, 2)
                      for a in (q, k, v))
        assert not tq.is_contiguous()
    else:
        tq, tk, tv = (_on(np.ascontiguousarray(a.transpose(0, 2, 1, 3)),
                          cuda_device, "bfloat16") for a in (q, k, v))
    tw = _on(w, cuda_device).transpose(1, 2).expand(B, H, S, 64)
    assert (tw.stride(-1) == 0) == (decay == "mamba2")
    got = _gla_routed(tq, tk, tv, tw, chunk, "mma")
    _gla_close(got, gla_scan_xla(tq, tk, tv, tw, chunk=chunk), "bfloat16")


@pytest.mark.gpu
def test_gla_scan_cuda_strided_and_broadcast_inputs(cuda_device):
    """The models' layouts: q/k/v as head-transposed views of (B, S, H, K)
    and Mamba2's per-head decay broadcast over K with stride 0 (fp32, so
    the CUDA-core route)."""
    B, S, H, K = 2, 150, 3, 32
    rng = np.random.default_rng(9)
    q, k, v = (_on(rng.standard_normal((B, S, H, K), np.float32) * 0.5,
                   cuda_device).transpose(1, 2) for _ in range(3))
    dt = _on(-0.05 * np.exp(rng.standard_normal((B, S, H), np.float32)),
             cuda_device)
    w = dt.transpose(1, 2)[..., None].expand(B, H, S, K)
    assert w.stride(-1) == 0 and not q.is_contiguous()
    got = _gla_routed(q, k, v, w, 64, "simt")
    _gla_close(got, gla_scan_xla(q, k, v, w, chunk=64), "float32")


@pytest.mark.gpu
def test_gla_scan_cuda_strong_decay_equals_plain(cuda_device):
    """w = -2.5: finite and equal to the plain version, whose exponent guard
    it copies (not to the naive recurrence, which the guard departs from);
    fp32, so the CUDA-core route."""
    case = (1, 1, 256, 32, 32, 128)
    q, k, v, _ = gla_inputs(case, seed=7)
    tq, tk, tv = (_on(a, cuda_device) for a in (q, k, v))
    tw = torch.full_like(tq, -2.5)
    got = _gla_routed(tq, tk, tv, tw, 128, "simt")
    _gla_close(got, gla_scan_xla(tq, tk, tv, tw, chunk=128), "float32")


@pytest.mark.gpu
def test_gla_scan_dispatcher_launches_the_kernel(cuda_device):
    q, k, v, w = (_on(a, cuda_device) for a in gla_inputs(GLA_CASES[2]))
    before = gla_scan_cuda.launches
    gla_scan(q, k, v, w, chunk=32)
    assert gla_scan_cuda.launches == before + 1


# ---------------------------------------------------------------------------
# The GLA scan's backward.
# ---------------------------------------------------------------------------

GLA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# GLA_CASES, a ragged S (200 over chunks of 64, and over 128), one chunk
# longer than S, and V 128 (two V tiles) with K 128 (two K tiles).
GLA_BWD_CASES = GLA_CASES + [(2, 2, 200, 64, 64, 64), (1, 3, 200, 64, 64, 128),
                             (1, 2, 37, 32, 16, 128), (1, 2, 150, 128, 128, 64)]


def _gla_bwd_inputs(case, dtype, device, seed=4):
    q, k, v, w = gla_inputs(case, seed=seed)
    rng = np.random.default_rng(seed + 1)
    do = rng.standard_normal(v.shape, np.float32)
    d_final = rng.standard_normal((*q.shape[:2], q.shape[3], v.shape[3]), np.float32)
    return ([_on(a, device, dtype) for a in (q, k, v)] + [_on(w, device)]
            + [_on(do, device, dtype), _on(d_final, device)])


def _gla_bwd_close(got, ref, dtype):
    assert [g.dtype for g in got] == [ref[0].dtype] * 3 + [torch.float32]
    for name, g, r in zip(("dq", "dk", "dv", "dw"), got, ref):
        assert g.shape == r.shape and torch.isfinite(g.float()).all(), name
        err = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
        assert err <= GLA_BWD_TOL[dtype], f"{name}: {err:.3e} of max |grad|"


def _gla_bwd_counted(*args, route=None):
    """gla_scan_bwd_cuda, with the launch counted on ``route`` (by default
    the one the rule names for these inputs) alone."""
    q, k, v, w, do, _, chunk = args
    route = route or bwd_route_gla(q, k, v, w, do, chunk)
    before = dict(gla_scan_bwd_cuda.launches_by_route)
    got = gla_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in gla_scan_bwd_cuda.launches_by_route.items()} == {
        r: int(r == route) for r in before}
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GLA_BWD_CASES)
def test_gla_scan_bwd_cuda_matches_plain(case, dtype, cuda_device):
    chunk = case[-1]
    q, k, v, w, do, d_final = _gla_bwd_inputs(case, dtype, cuda_device)
    for df in (d_final, None):
        got = _gla_bwd_counted(q, k, v, w, do, df, chunk)
        _gla_bwd_close(got, gla_scan_bwd_ref(q, k, v, w, do, df, chunk), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_scan_bwd_cuda_models_layouts(dtype, cuda_device):
    """q/k/v and dO as head-transposed views of (B, S, H, *) and Mamba2's
    per-head decay broadcast over K with stride 0, at a ragged S."""
    B, S, H, Kd, V = 2, 150, 3, 32, 64
    rng = np.random.default_rng(9)
    q, k = (_on(rng.standard_normal((B, S, H, Kd), np.float32) * 0.5, cuda_device,
                dtype).transpose(1, 2) for _ in range(2))
    v, do = (_on(rng.standard_normal((B, S, H, V), np.float32), cuda_device,
                 dtype).transpose(1, 2) for _ in range(2))
    dt = _on(-0.05 * np.exp(rng.standard_normal((B, S, H), np.float32)), cuda_device)
    w = dt.transpose(1, 2)[..., None].expand(B, H, S, Kd)
    assert w.stride(-1) == 0 and not q.is_contiguous() and not do.is_contiguous()
    got = _gla_bwd_counted(q, k, v, w, do, None, 64)
    _gla_bwd_close(got, gla_scan_bwd_ref(q, k, v, w, do, None, 64), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("decay", ["strong", "exact bounds"])
def test_gla_scan_bwd_cuda_guard_and_clip_ties(decay, cuda_device):
    """w = -2.5 (the guard saturates), and w at the exact bounds of the clip
    and the guard (half derivatives), in fp32."""
    if decay == "strong":
        case = (1, 2, 256, 32, 32, 128)
        q, k, v, w = gla_inputs(case, seed=7)
        w = np.full(q.shape, -2.5, np.float32)
    else:
        case, (q, k, v, w) = gla_exact_bound_inputs()
    rng = np.random.default_rng(1)
    do = rng.standard_normal(v.shape, np.float32)
    args = [_on(a, cuda_device) for a in (q, k, v, w, do)]
    got = _gla_bwd_counted(*args, None, case[-1])
    _gla_bwd_close(got, gla_scan_bwd_ref(*args, None, case[-1]), "float32")


def _gla_bwd_simt(q, k, v, w, do, d_final, chunk):
    """The CUDA-core backward through its C entry point, on any call it
    takes (the wrapper would send a bf16 K = V = 64 call to mma)."""
    from repro_torch.kernels import _build

    lib, symbol, argtypes = GLA_BWD_LIBS["simt"]
    B, H, S, Kd = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    dw = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    states = torch.empty((B, H, -(-S // C), Kd, V), dtype=torch.float32, device=q.device)
    dstates = torch.empty_like(states)
    strides = [s for t in (q, k, v, w, do) for s in t.stride()]
    code = _build.function(lib, symbol, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), do.data_ptr(),
        None if d_final is None else d_final.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), states.data_ptr(), dstates.data_ptr(), B, H, S,
        Kd, V, C, *strides, 1, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    torch.cuda.synchronize()
    return dq, dk, dv, dw


# B, H, S, chunk, decay: calls of the tensor-core backward (bf16, K = V =
# 64), chunks of 128, 64, 48 and 16, a ragged S and strong decay.
GLA_BWD_MMA_CASES = [(2, 4, 256, 128, "rwkv6"), (1, 3, 300, 128, "rwkv6"),
                     (2, 2, 200, 64, "rwkv6"), (1, 2, 200, 48, "rwkv6"),
                     (1, 2, 40, 16, "rwkv6"), (1, 2, 256, 128, "strong")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GLA_BWD_MMA_CASES)
def test_gla_scan_bwd_cuda_mma_matches_plain_and_simt(case, cuda_device):
    """The tensor-core backward against gla_scan_bwd_ref (2e-2 of the
    largest |gradient|; dw, fp32, within 1e-4) and against the CUDA-core
    kernel on the same call, with and without the final state's gradient."""
    B, H, S, chunk, decay = case
    q, k, v, w, do, d_final = _gla_bwd_inputs((B, H, S, 64, 64, chunk), "bfloat16",
                                              cuda_device)
    if decay == "strong":
        w = torch.full_like(w, -2.5)
    for df in (d_final, None):
        got = _gla_bwd_counted(q, k, v, w, do, df, chunk, route="mma")
        ref = gla_scan_bwd_ref(q, k, v, w, do, df, chunk)
        _gla_bwd_close(got, ref, "bfloat16")
        _gla_bwd_close(got, _gla_bwd_simt(q, k, v, w, do, df, chunk), "bfloat16")
        dw_err = ((got[3] - ref[3]).abs().max() / ref[3].abs().max()).item()
        assert dw_err <= GLA_BWD_TOL["float32"], f"dw: {dw_err:.3e}"


@pytest.mark.gpu
def test_gla_scan_bwd_cuda_mma_stride_zero_w_and_views(cuda_device):
    """Mamba2's call: head-transposed bf16 q/k/v and dO views and one decay
    per head broadcast over K with stride 0, on the tensor cores; and a dO
    that starts 2 bytes into its buffer, which the wrapper copies so that
    the call stays there."""
    B, S, H = 2, 300, 3
    rng = np.random.default_rng(9)
    q, k = (_on(rng.standard_normal((B, S, H, 64), np.float32) * 0.5, cuda_device,
                "bfloat16").transpose(1, 2) for _ in range(2))
    v, do = (_on(rng.standard_normal((B, S, H, 64), np.float32), cuda_device,
                 "bfloat16").transpose(1, 2) for _ in range(2))
    dt = _on(-0.05 * np.exp(rng.standard_normal((B, S, H), np.float32)), cuda_device)
    w = dt.transpose(1, 2)[..., None].expand(B, H, S, 64)
    assert w.stride(-1) == 0 and not q.is_contiguous() and not do.is_contiguous()
    ref = gla_scan_bwd_ref(q, k, v, w, do, None, 128)
    _gla_bwd_close(_gla_bwd_counted(q, k, v, w, do, None, 128, route="mma"), ref,
                   "bfloat16")
    odd = torch.empty((B, H, S, 72), dtype=torch.bfloat16, device=cuda_device)[..., 1:65]
    odd.copy_(do)
    assert odd.data_ptr() % 16 and bwd_route_gla(q, k, v, w, odd, 128) == "simt"
    _gla_bwd_close(_gla_bwd_counted(q, k, v, w, odd, None, 128, route="mma"), ref,
                   "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_scan_bwd_cuda_is_deterministic(dtype, cuda_device):
    case = (2, 4, 300, 64, 64, 128)
    args = _gla_bwd_inputs(case, dtype, cuda_device)
    a = _gla_bwd_counted(*args, 128, route="mma" if dtype == "bfloat16" else "simt")
    b = gla_scan_bwd_cuda(*args, 128)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [("float32", "simt"), ("bfloat16", "mma")])
def test_gla_scan_autograd_goes_through_the_kernels(dtype, route, cuda_device):
    """The dispatcher's cuda path under autograd (``GlaScanFn``): one
    forward launch on its route and one backward launch, gradients of o and
    the final state as autograd of the plain path gives them, with Mamba2's
    stride-0 w, whose gradient autograd sums over K."""
    case = (2, 4, 256, 64, 64, 128)
    q, k, v, w, do, d_final = _gla_bwd_inputs(case, dtype, cuda_device)
    w1 = w[..., :1].clone()
    grads = {}
    for name, fn in (("kernel", gla_scan), ("plain", gla_scan_xla)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, w1)]
        fwd, bwd = gla_scan_cuda.launches_by_route[route], gla_scan_bwd_cuda.launches
        o, s = fn(*leaves[:3], leaves[3].expand(w.shape), chunk=128)
        torch.autograd.backward((o, s), (do, d_final))
        torch.cuda.synchronize()
        if name == "kernel":
            assert (gla_scan_cuda.launches_by_route[route] - fwd,
                    gla_scan_bwd_cuda.launches - bwd) == (1, 1)
        grads[name] = [t.grad for t in leaves]
    _gla_bwd_close(grads["kernel"], grads["plain"], dtype)
    before = gla_scan_bwd_cuda.launches
    with torch.no_grad():
        gla_scan(q, k, v, w, chunk=128)
    assert gla_scan_bwd_cuda.launches == before
