"""The paged-attention wrapper's route rule, its autograd guard, and the
arithmetic of its cluster-split route, on the CPU.

Calls with D in {64, 128}, 1 <= G <= 9, a page that is a multiple of 16
and 16-byte aligned q and pools take the cluster-split kernel (``split``);
every other call the CUDA-core kernel (``simt``).  The kernels themselves
are held against the plain version on a card by
``test_torch_kernels_gpu.py``.  Here a torch emulation of the split kernel's
arithmetic (pages dealt round-robin over the C blocks of a cluster, each
block's rows dealt in steps to four warps with their own online softmax in
base 2, then the warps' and the blocks' combine) is held against the JAX
package's ``paged_attention_ref`` within the fp32 tolerance, on both the
fp32 path and the bf16 path's tensor-core arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import kernel as K

TOL_FP32 = 2e-5             # tests/test_kernels.py, fp32
LOG2E = 1.4426950408889634
WARPS = 4                   # warps a block


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D,page", [
    (8, 64, 128),            # tinyllama_1p1b
    (5, 128, 128),           # qwen2p5_14b
    (9, 128, 16),            # starcoder2_7b
    (3, 64, 16),             # granite_moe_3b_a800m
    (1, 64, 64),             # zamba2_1p2b's shared attention
    (6, 128, 128),           # dbrx_132b
    (8, 128, 128),           # qwen2_vl_72b
])
def test_route_takes_split_for_the_served_configs(dtype, G, D, page):
    assert K.route(dtype, G, D, page, 256) == "split"


@pytest.mark.parametrize("G,D,page,alignment", [
    (4, 32, 16, 256),        # D 32 (the reduced configs)
    (8, 96, 16, 256),
    (8, 64, 4, 256),         # too small a page
    (8, 64, 8, 256),
    (8, 64, 24, 256),        # not a multiple of 16
    (8, 64, 128, 8),         # misaligned pools
    (8, 64, 128, 2),
    (10, 64, 128, 256),      # G past 9
])
def test_route_takes_simt_otherwise(G, D, page, alignment):
    for dtype in (torch.bfloat16, torch.float32):
        assert K.route(dtype, G, D, page, alignment) == "simt"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="paged_attention_cuda"):
        K.route(dtype, 8, 64, 128, 256)


def test_route_counters_cover_every_route():
    assert set(K.paged_attention_cuda.launches_by_route) == set(K._LIBS)


def _call(B=2, Hq=8, Hkv=2, D=64, P=4, page=16, maxp=2, dtype=torch.float32,
          grad=False):
    q = torch.zeros(B, Hq, D, dtype=dtype, requires_grad=grad)
    pool = torch.zeros(P, page, Hkv, D, dtype=dtype)
    return (q, pool, pool, torch.zeros(B, maxp, dtype=torch.int32),
            torch.ones(B, dtype=torch.int32))


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if a kernel library is built or loaded; checks that no
    launch was counted."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    libs = dict(_build._libs)
    fn = K.paged_attention_cuda
    launches = (fn.launches, dict(fn.launches_by_route))
    yield
    assert _build._libs == libs
    assert (fn.launches, fn.launches_by_route) == launches


@pytest.mark.parametrize("args", [
    _call(), _call(dtype=torch.bfloat16), _call(D=32), _call(page=4),
])
def test_cpu_tensors_raise_before_any_library(args, no_library):
    with pytest.raises(ValueError, match="CUDA device"):
        K.paged_attention_cuda(*args)


def test_autograd_guard_raises_before_the_device_check(no_library):
    """The kernel has no backward: a call autograd would record raises, and
    it does so before the device check, whatever the device."""
    with pytest.raises(RuntimeError, match="no backward"):
        K.paged_attention_cuda(*_call(grad=True))
    q, kp, vp, bt, sl = _call()
    kp = kp.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        K.paged_attention_cuda(q, kp, vp, bt, sl)


@pytest.mark.parametrize("context", [torch.no_grad, torch.inference_mode])
def test_autograd_guard_passes_without_grad(context, no_library):
    """Under no_grad or inference_mode the same call passes the guard and
    meets the device check."""
    with context(), pytest.raises(ValueError, match="CUDA device"):
        K.paged_attention_cuda(*_call(grad=True))


# ---------------------------------------------------------------------------
# The split route's arithmetic, emulated in torch.
# ---------------------------------------------------------------------------


def _merge(parts):
    """Partial softmaxes (m, l, acc) in base 2 -> their combine: M = max m_i,
    l = sum l_i 2^(m_i - M), acc = sum acc_i 2^(m_i - M)."""
    m = torch.stack([p[0] for p in parts])
    M = m.max(0).values
    f = torch.exp2(m - M)
    l = (torch.stack([p[1] for p in parts]) * f).sum(0)
    acc = (torch.stack([p[2] for p in parts]) * f[..., None]).sum(0)
    return M, l, acc


def split_emulation(q, kp, vp, bt, sl, C, mma=False, scale=None):
    """paged attention as the split kernel computes it, with C blocks a
    cluster; ``mma`` takes the bf16 path (16-row steps, the raw product
    scaled after, P split into bf16 hi and lo), else the fp32 path (8-row
    steps, q scaled before).

    This is a hand copy of the kernel's arithmetic and shares no code with
    it: a change to src/repro_torch/csrc/split_decode.cuh (the body the
    paged and dense split kernels share) or paged_attention_split.cu is
    made here too.  Each part follows these lines of those files:

    * the block's pages r, r + C, ... and its row count:
      split_decode.cuh:111-117, paged_attention_split.cu:78-84;
    * a warp's steps, rows [base, base + rows), base = (s * 4 + w) * rows:
      split_decode.cuh:131-135;
    * fp32: q scaled by scale * log2(e) (:162), the scores, rows past the
      sequence at -1e30 (:198-224), the rescale when the max grows
      (:226-242), p = 2^(s - m), l and acc (:243-254);
    * bf16: Q K^T on the tensor cores, then the scale and the mask
      (:345-364), the rescale (:369-380), p (:382-389), P split hi/lo
      (:393-396) and P V as hi V + lo V (:398-405);
    * the warps' combine (:467-488) and the cluster's, out =
      acc / (l + 1e-30) (:493-514).
    """
    B, Hq, D = q.shape
    P, page, Hkv, _ = kp.shape
    G, maxp = Hq // Hkv, bt.shape[1]
    rows = 16 if mma else 8
    scale = (D ** -0.5 if scale is None else scale) * LOG2E
    qf = q.float().view(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        length = min(max(int(sl[b]), 0), maxp * page)
        used = -(-length // page)
        for h in range(Hkv):
            blocks = []
            for r in range(C):
                pages = list(range(r, used, C))
                total = len(pages) * page
                if pages and pages[-1] == used - 1:
                    total -= used * page - length
                phys = [int(bt[b, p]) for p in pages]
                k = kp[phys, :, h].reshape(-1, D).float()
                v = vp[phys, :, h].reshape(-1, D).float()
                warps = []
                for w in range(WARPS):
                    m = torch.full((G,), -1e30)
                    l, acc = torch.zeros(G), torch.zeros(G, D)
                    for base in range(w * rows, total, WARPS * rows):
                        kt, vt = k[base:base + rows], v[base:base + rows]
                        s = (qf[b, h] @ kt.T) * scale if mma else (qf[b, h] * scale) @ kt.T
                        s = torch.where(torch.arange(base, base + rows) < total, s, -1e30)
                        new = torch.maximum(m, s.max(1).values)
                        alpha = torch.exp2(m - new)
                        m, l, acc = new, l * alpha, acc * alpha[:, None]
                        p = torch.exp2(s - m[:, None])
                        l = l + p.sum(1)
                        if mma:
                            hi = p.bfloat16().float()
                            acc = acc + hi @ vt + (p - hi).bfloat16().float() @ vt
                        else:
                            acc = acc + p @ vt
                    warps.append((m, l, acc))
                blocks.append(_merge(warps))
            _, l, acc = _merge(blocks)
            out[b, h] = acc / (l + 1e-30)[:, None]
    return out.view(B, Hq, D)


# Lengths 1, page +- 1, 2 page +- 1, ..., max_pages * page at page 16:
# with C = 8, the short ones leave most blocks without a page.
SEQ_LENS = (1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 129, 192)


def _inputs(G=3, Hkv=2, D=64, P=40, page=16, maxp=12, lens=SEQ_LENS, mma=False,
            seed=6):
    """q, pools and a table of distinct pages per sequence, as float32
    numpy; bf16-exact values for the bf16 path, so both sides see the same
    inputs."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.standard_normal((B, Hkv * G, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    if mma:
        q, kp, vp = (torch.from_numpy(a).bfloat16().float().numpy()
                     for a in (q, kp, vp))
    bt = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("mma", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_split_arithmetic_equals_jax_ref(C, mma):
    """Ragged lengths on both sides of the page and split boundaries, and
    blocks with no page, within the fp32 tolerance of the JAX reference; on
    the bf16 path the hi/lo split of P keeps its rounding (about 2^-16 of
    each weight) inside that tolerance too."""
    q, kp, vp, bt, sl = _inputs(mma=mma)
    ref = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, bt, sl))))
    got = split_emulation(*(torch.from_numpy(a) for a in (q, kp, vp, bt, sl)),
                          C, mma=mma)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL_FP32, rtol=TOL_FP32)


@pytest.mark.parametrize("mma", [False, True], ids=["fp32", "bf16"])
def test_split_arithmetic_at_d128_and_nine_heads(mma):
    """starcoder2's G 9 at D 128, page 32, with C = 8 over 10 table columns."""
    q, kp, vp, bt, sl = _inputs(G=9, Hkv=1, D=128, P=12, page=32, maxp=10,
                                lens=(1, 31, 33, 257, 320), mma=mma, seed=8)
    ref = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, bt, sl))))
    got = split_emulation(*(torch.from_numpy(a) for a in (q, kp, vp, bt, sl)),
                          8, mma=mma)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL_FP32, rtol=TOL_FP32)


@pytest.mark.parametrize("mma", [False, True], ids=["fp32", "bf16"])
def test_split_arithmetic_gives_zeros_at_zero_length(mma):
    """seq_len == 0: every block contributes m = -1e30, l = 0, acc = 0, and
    acc / (l + 1e-30) is 0, as the Pallas kernel (the jnp reference gives
    the mean of V there)."""
    q, kp, vp, bt, sl = (torch.from_numpy(a) for a in _inputs(lens=(0, 17, 0)))
    got = split_emulation(q, kp, vp, bt, sl, 8, mma=mma)
    assert torch.count_nonzero(got[0]) == 0 and torch.count_nonzero(got[2]) == 0
    assert torch.count_nonzero(got[1]) == got[1].numel()
