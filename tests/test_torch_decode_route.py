"""The dense decode attention's route, its dispatcher on the CPU, the
kernel wrapper's refusals, and the arithmetic of its split kernel.

Calls of bf16 or fp32 CUDA tensors (not DTensors) with D in {64, 128},
1 <= G <= 9 and 16-byte aligned q and caches take the cluster-split kernel
(``split``); every other call the plain body (``plain``), which is the JAX
package's ``_decode_attend`` as the port ran it before.  The kernel itself
is held against the plain body on a card by ``test_torch_kernels_gpu.py``.
Here its row addressing (16-position units dealt round-robin over the C
blocks of a cluster) is checked to read every live position once and none
past ``valid``, and its arithmetic, which is the paged split kernel's over
an identity block table of 16-position pages, is held to the plain body.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import layers as TL
from test_torch_paged_route import TOL_FP32, split_emulation

UNIT = 16                   # positions a unit of the dense kernel
MAX_CLUSTER = 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D", [
    (8, 64),                 # tinyllama_1p1b
    (5, 128),                # qwen2p5_14b
    (9, 128),                # starcoder2_7b
    (3, 64),                 # granite_moe_3b_a800m
    (1, 64),                 # zamba2_1p2b's shared attention, seamless_m4t
    (6, 128),                # dbrx_132b
    (8, 128),                # qwen2_vl_72b
])
def test_rule_takes_split_for_the_served_configs(dtype, G, D):
    assert K.rule(dtype, G, D, 256) == "split"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 320])
@pytest.mark.parametrize("G", [1, 5, 9, 10])
def test_rule_over_head_dims_and_groups(dtype, D, G):
    """D 320 (gemma3_4b) and G past 9 stay plain."""
    want = "split" if D in (64, 128) and G <= 9 else "plain"
    assert K.rule(dtype, G, D, 16) == want


@pytest.mark.parametrize("dtype,G,D,alignment", [
    (torch.float16, 8, 64, 256),
    (torch.float64, 8, 64, 256),
    (torch.bfloat16, 4, 32, 256),     # the reduced configs' head dim
    (torch.bfloat16, 8, 96, 256),
    (torch.bfloat16, 0, 64, 256),     # Hq not a multiple of Hkv
    (torch.bfloat16, 8, 64, 8),       # misaligned q or caches
    (torch.float32, 8, 64, 2),
])
def test_rule_takes_plain_otherwise(dtype, G, D, alignment):
    assert K.rule(dtype, G, D, alignment) == "plain"


def test_launch_counters_cover_the_route():
    assert set(K.decode_attention_cuda.launches_by_route) == {"split"}


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if a kernel library is built or loaded; checks that no
    launch was counted."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    libs = dict(_build._libs)
    fn = K.decode_attention_cuda
    launches = (fn.launches, dict(fn.launches_by_route))
    yield
    assert _build._libs == libs
    assert (fn.launches, fn.launches_by_route) == launches


def _old_decode_attend(q, k_cache, v_cache, valid_len):
    """``layers._decode_attend`` as it stood before the dense kernel (its
    unused ``cfg`` left out), kept here to hold the plain body to it."""
    from repro_torch.distributed.sharding import constrain_kv_layout, splittable
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qf = q.float() * (hd ** -0.5)                         # (B,1,H,hd)
    kf = constrain_kv_layout(k_cache.float())
    vf = constrain_kv_layout(v_cache.float())
    qg = splittable(qf, 2, KV).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)           # (B,KV,G,S)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, None, None, :] < valid_len
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _decode_call(window, kv_len, dtype=torch.float32, seed=9):
    """q and caches at the shapes of test_torch_layers.py's
    test_attention_decode_writes_slot (B 2, 4 heads over 2 of 8, a cache of
    12 or a ring of ``window``), and ``valid`` as attention_decode makes it."""
    rng = np.random.default_rng(seed)
    S_cache = window or 12
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
                 for s in ((2, 1, 4, 8), (2, S_cache, 2, 8), (2, S_cache, 2, 8)))
    kv = TL.kv_len_tensor(kv_len, "cpu")
    return q, kc, vc, torch.clamp(kv + 1, max=S_cache)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,kv_len", [(None, 5), (4, 9)])
def test_dispatcher_sends_cpu_calls_to_the_old_body(window, kv_len, dtype,
                                                    no_library):
    q, kc, vc, valid = _decode_call(window, kv_len, dtype)
    assert ops.route(q, kc, vc) == "plain"
    got = decode_attention(q, kc, vc, valid)
    assert torch.equal(got, _old_decode_attend(q, kc, vc, valid))
    assert torch.equal(got, decode_attention_ref(q, kc, vc, valid))
    assert got.dtype == dtype and got.shape == q.shape


@pytest.mark.parametrize("window,kv_len", [(None, 5), (4, 9)])
def test_attention_decode_equals_the_old_body(window, kv_len, monkeypatch,
                                              no_library):
    """attention_decode through the dispatcher gives the bits it gave with
    the old body in its place."""
    cfg = TL.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                        window=window)
    rng = np.random.default_rng(8)
    params = {k: torch.from_numpy(rng.standard_normal(s, np.float32) / 6)
              for k, s in (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
                           ("wo", (32, 32)))}
    S_cache = window or 12
    caches = [torch.from_numpy(rng.standard_normal((2, S_cache, 2, 8), np.float32))
              for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal((2, 1, 32), np.float32))
    pos = torch.full((2, 1), kv_len, dtype=torch.int32)
    got, _, _ = TL.attention_decode(params, x, cfg, caches[0].clone(),
                                    caches[1].clone(), kv_len, pos)
    monkeypatch.setattr(TL, "decode_attention", _old_decode_attend)
    want, _, _ = TL.attention_decode(params, x, cfg, caches[0].clone(),
                                     caches[1].clone(), kv_len, pos)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def cpu_mesh():
    """A gloo world of one and its 1 x 1 CPU mesh, torn down after the
    module."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            yield make_test_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


def test_dtensor_calls_take_the_plain_body(cpu_mesh, no_library):
    """A sharded model's DTensors go to the plain body, whose sharding hooks
    they need; the kernel wrapper refuses them."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    q, kc, vc, valid = _decode_call(None, 5)
    dq, dk, dv = (distribute_tensor(t, cpu_mesh, [Replicate(), Replicate()]) for t in (q, kc, vc))
    assert ops.route(dq, dk, dv) == "plain"
    assert ops.route(q, dk, vc) == "plain"
    with implicit_replication():               # as the sharded step runs
        got = decode_attention(dq, dk, dv, valid)
    assert torch.equal(got.full_tensor(), _old_decode_attend(q, kc, vc, valid))
    with pytest.raises(TypeError, match="DTensor"):
        K.decode_attention_cuda(dq.reshape(2, 4, 8), dk, dv, valid.int())


class _OnCard:
    """A CPU tensor that says it lives on a card: what ``route`` reads of a
    call, without one."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _card_call(S=32, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(4)
    return [torch.randn(*shape, generator=g).to(dtype)
            for shape in ((2, 1, 8, 64), (2, S, 2, 64), (2, S, 2, 64))]


def _grad_q(q, k, v):
    return q.clone().requires_grad_(), k, v


@pytest.mark.parametrize("change,want", [
    (lambda q, k, v: (q, k, v), "split"),
    (lambda q, k, v: (q.float(), k.float(), v.float()), "split"),
    (lambda q, k, v: (q, _card_call(48)[1][:, :32], v), "plain"),   # strided cache
    (lambda q, k, v: (q, k, _card_call(48)[2][:, 8:40]), "plain"),
    (lambda q, k, v: (torch.cat([q, q], -1)[..., :64], k, v), "plain"),     # strided q
    (_grad_q, "plain"),                                         # autograd records it
    (lambda q, k, v: (q, k, v[:, :16]), "plain"),
    (lambda q, k, v: (q.expand(2, 2, 8, 64).contiguous(), k, v), "plain"),
    (lambda q, k, v: (q[..., :32].contiguous(), k, v), "plain"),
    (lambda q, k, v: (q[:1], k, v), "plain"),
    (lambda q, k, v: (q, k.float(), v), "plain"),
])
def test_route_on_a_card_call(change, want):
    """``route``'s own checks (``rule`` aside), on calls that say they are
    on a card: a strided cache or q, a call autograd would record, or
    shapes that disagree keep the plain body."""
    args = [_OnCard(t) for t in change(*_card_call())]
    assert ops.route(*args) == want


def test_route_under_no_grad_takes_split():
    args = [_OnCard(t) for t in _grad_q(*_card_call())]
    assert ops.route(*args) == "plain"
    with torch.no_grad():
        assert ops.route(*args) == "split"


@pytest.mark.parametrize("valid,want", [
    (None, "split"),
    (torch.tensor(5, dtype=torch.int32), "plain"),               # not on the card
    (_OnCard(torch.tensor(5, dtype=torch.int32)), "plain"),     # not a tensor
    (5, "plain"),
])
def test_route_reads_valid_when_given(valid, want):
    assert ops.route(*(_OnCard(t) for t in _card_call()), valid) == want


def test_dispatcher_takes_a_strided_cpu_cache(no_library):
    """A strided cache (a slice along S) on the CPU: the plain body."""
    q, k, v = _card_call(48)
    kc, vc = k[:, :32], v[:, :32]
    valid = torch.tensor(20, dtype=torch.int32)
    assert not kc.is_contiguous() and ops.route(q, kc, vc, valid) == "plain"
    assert torch.equal(decode_attention(q, kc, vc, valid),
                       _old_decode_attend(q, kc, vc, valid))


def _kernel_args(B=2, Hq=8, Hkv=2, D=64, S=32, dtype=torch.bfloat16, grad=False):
    q = torch.zeros(B, Hq, D, dtype=dtype, requires_grad=grad)
    cache = torch.zeros(B, S, Hkv, D, dtype=dtype)
    return q, cache, cache.clone(), torch.tensor(5, dtype=torch.int32)


@pytest.mark.parametrize("change,error,match", [
    (lambda a: (a[0].half(), a[1].half(), a[2].half(), a[3]), TypeError, "q dtype"),
    (lambda a: (a[0], a[1].float(), a[2], a[3]), TypeError, "share a dtype"),
    (lambda a: (a[0], a[1], a[2], a[3].long()), TypeError, "0-d int32"),
    (lambda a: (a[0], a[1], a[2], a[3].view(1)), TypeError, "0-d int32"),
    (lambda a: (a[0], a[1], a[2][:, :16], a[3]), ValueError, "bad shapes"),
    (lambda a: (a[0][:1], a[1], a[2], a[3]), ValueError, "bad shapes"),
    (lambda a: (a[0][..., :32], a[1], a[2], a[3]), ValueError, "bad shapes"),
    (lambda a: (a[0][:, :7], a[1], a[2], a[3]), ValueError, "bad shapes"),
    (lambda a: (a[0], a[1][:, :0], a[2][:, :0], a[3]), ValueError, "bad shapes"),
    (lambda a: (a[0], a[1].transpose(0, 1).contiguous().transpose(0, 1), a[2], a[3]),
     ValueError, "contiguous"),
    (lambda a: (a[0].transpose(0, 1).contiguous().transpose(0, 1), a[1], a[2], a[3]),
     ValueError, "contiguous"),
    (lambda a: a, ValueError, "CUDA device"),
])
def test_kernel_wrapper_refusals(change, error, match, no_library):
    with pytest.raises(error, match=match):
        K.decode_attention_cuda(*change(_kernel_args()))


def test_kernel_wrapper_refuses_grad_before_the_device_check(no_library):
    """The kernel has no backward: a call autograd would record raises,
    before the device check; under no_grad the same call meets it."""
    with pytest.raises(RuntimeError, match="no backward"):
        K.decode_attention_cuda(*_kernel_args(grad=True))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        K.decode_attention_cuda(*_kernel_args(grad=True))


# ---------------------------------------------------------------------------
# The split kernel's row addressing and arithmetic.
# ---------------------------------------------------------------------------


def dense_block_positions(valid, S_cache):
    """The cache positions each block of a cluster reads, as
    decode_attention_split.cu addresses them: C = min(ceil(S_cache / 16), 8)
    (its launcher), the block's units and rows by ``block_share``
    (split_decode.cuh:111-117), and block row i at position
    ((i // 16) * C + rank) * 16 + i % 16 (``DenseRows``)."""
    C = min(-(-S_cache // UNIT), MAX_CLUSTER)
    length = min(max(valid, 0), S_cache)
    used = -(-length // UNIT)
    blocks = []
    for rank in range(C):
        units = (used - rank + C - 1) // C if used > rank else 0
        rows = units * UNIT
        if units and (used - 1) % C == rank:
            rows -= used * UNIT - length
        blocks.append([((i // UNIT) * C + rank) * UNIT + i % UNIT
                       for i in range(rows)])
    return blocks


@pytest.mark.parametrize("S_cache,valids", [
    (1, (0, 1)),
    (4, (1, 3, 4)),                     # a window ring shorter than a unit
    (12, (1, 6, 12)),
    (16, (1, 15, 16)),
    (17, (1, 16, 17)),
    (100, (1, 15, 16, 17, 33, 99, 100)),
    (3904, (1, 17, 3072, 3903, 3904)),  # starcoder2_7b.repo_decode's cache
    (4128, (1, 17, 2049, 4127, 4128)),  # qwen2p5_14b.doc_prefill's
])
def test_dense_blocks_read_each_live_position_once(S_cache, valids):
    for valid in valids:
        blocks = dense_block_positions(valid, S_cache)
        read = sorted(p for b in blocks for p in b)
        assert read == list(range(valid)), (S_cache, valid)


def _dense_inputs(B, S_cache, Hkv, G, D, seed):
    """bf16-exact float32 q and caches."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal(s, np.float32) for s in
            ((B, 1, Hkv * G, D), (B, S_cache, Hkv, D), (B, S_cache, Hkv, D)))
    return [torch.from_numpy(a).bfloat16().float() for a in arrs]


@pytest.mark.parametrize("mma", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S_cache,Hkv,G,D,valid", [
    (2, 96, 2, 3, 64, 1),
    (2, 96, 2, 3, 64, 37),              # C 6, a partial last unit
    (2, 96, 2, 3, 64, 96),
    (1, 320, 1, 9, 128, 257),           # C 8 over 20 units, G 9 at D 128
    (2, 64, 2, 5, 128, 64),             # G 5 at D 128, C 4
])
def test_dense_arithmetic_equals_the_plain_body(B, S_cache, Hkv, G, D, valid, mma):
    """The dense kernel is the paged split kernel over an identity table of
    16-position pages at the same C, so its arithmetic is split_emulation's
    there; held to the plain body within the fp32 tolerance."""
    q, kc, vc = _dense_inputs(B, S_cache, Hkv, G, D, seed=valid)
    n = S_cache // UNIT
    pool_k = kc.reshape(B * n, UNIT, Hkv, D)
    pool_v = vc.reshape(B * n, UNIT, Hkv, D)
    table = torch.arange(B * n, dtype=torch.int32).view(B, n)
    lens = torch.full((B,), valid, dtype=torch.int32)
    C = min(n, MAX_CLUSTER)
    got = split_emulation(q[:, 0], pool_k, pool_v, table, lens, C, mma=mma)
    ref = decode_attention_ref(q, kc, vc, torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), ref[:, 0].numpy(), atol=TOL_FP32,
                               rtol=TOL_FP32)
