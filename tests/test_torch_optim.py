"""The port's optimizer, schedules and gradient compression
(``repro_torch.optim``) against ``repro.optim`` on the same numpy inputs,
and ports of the reference's own optimizer tests
(``tests/test_substrates.py``).

Tolerances: fp32 leaves 1e-6 relative and absolute (the same arithmetic
in the same order per element; the global norm's sums run in another
order); bf16 parameters within one bf16 step (2^-8 relative) of JAX's,
since an fp32 result a rounding away from a bf16 boundary may round the
other way; the schedule within 1e-6 relative (a few fp32 steps: the two
frameworks round cos differently); int8 codes exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro_torch.optim import (adamw_init, adamw_update, compress_tree,
                               decompress_tree, init_compression, warmup_cosine)
from repro_torch.optim.adamw import clip_by_global_norm, global_norm
from repro_torch.optim.compression import compressed_ratio
from repro_torch.optim.schedules import constant

FP32 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=2 ** -8, atol=1e-6)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": (scale * rng.standard_normal((16, 8))).astype(np.float32),
                      "b": (scale * rng.standard_normal(8)).astype(np.float32)},
            "emb": (scale * rng.standard_normal((32, 4))).astype(np.float32),
            "stack": (scale * rng.standard_normal((3, 5, 6))).astype(np.float32)}


def _jax(tree, dtype):
    return {k: _jax(v, dtype) if isinstance(v, dict) else jnp.asarray(v, dtype)
            for k, v in tree.items()}


def _torch(tree, dtype):
    return {k: _torch(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _close(t, j, tol):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _close(t[k], j[k], tol)
        return
    assert t.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                       jnp.int8: torch.int8, jnp.int32: torch.int32}[j.dtype.type]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_grad_norm", [None, 1.0])
def test_adamw_update_matches_jax(dtype, max_grad_norm):
    """Three updates with the state carried, weight decay on the ndim >= 2
    leaves only; grads of norm about 18, so clipping at 1.0 scales them."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp, tp = _jax(_np_tree(0), jd), _torch(_np_tree(0), td)
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = _np_tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, js, jn = jadamw.adamw_update(_jax(g, jd), js, jp, jnp.float32(lr),
                                         max_grad_norm=max_grad_norm)
        tp, ts, tn = adamw_update(_torch(g, td), ts, tp, torch.tensor(lr),
                                  max_grad_norm=max_grad_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close(tp, jp, FP32 if dtype == "float32" else BF16)
        _close(ts.mu, js.mu, FP32)
        _close(ts.nu, js.nu, FP32)
        assert int(ts.count) == int(js.count) == step + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_jax(dtype):
    g = _np_tree(3, scale=5.0)
    jn = jadamw.global_norm(_jax(g, getattr(jnp, dtype)))
    np.testing.assert_allclose(float(global_norm(_torch(g, getattr(torch, dtype)))),
                               float(jn), rtol=1e-6)
    jc, _ = jadamw.clip_by_global_norm(_jax(g, getattr(jnp, dtype)), 2.0)
    tc, _ = clip_by_global_norm(_torch(g, getattr(torch, dtype)), 2.0)
    _close(tc, jc, FP32)


def test_warmup_cosine_matches_jax_every_step():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in range(101):
        ours = warmup_cosine(step, **kw)
        assert ours.dtype == torch.float32 and ours.dim() == 0
        np.testing.assert_allclose(float(ours),
                                   float(jsched.warmup_cosine(step, **kw)),
                                   rtol=1e-6, atol=0)
    assert float(constant(7, lr=0.5)) == float(jsched.constant(7, lr=0.5)) == 0.5


def test_compress_decompress_match_jax():
    """Two rounds with the residual carried: the int8 codes equal JAX's,
    the scales, residuals and dequantized leaves agree to fp32."""
    seqs = [_np_tree(20 + i, scale=3.0) for i in range(2)]
    js = jcomp.init_compression(_jax(seqs[0], jnp.float32))
    ts = init_compression(_torch(seqs[0], torch.float32))
    for g in seqs:
        jq, jsc, js = jcomp.compress_tree(_jax(g, jnp.float32), js)
        tq, tsc, ts = compress_tree(_torch(g, torch.float32), ts)
        _close(tq, jq, dict(rtol=0, atol=0))
        _close(tsc, jsc, FP32)
        _close(ts.error, js.error, FP32)
        _close(decompress_tree(tq, tsc), jcomp.decompress_tree(jq, jsc), FP32)
    g = _np_tree(0)
    assert compressed_ratio(_torch(g, torch.float32)) == pytest.approx(
        jcomp.compressed_ratio(_jax(g, jnp.float32)), rel=1e-12)


# Ports of tests/test_substrates.py's optimizer tests.


def test_adamw_converges_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        grads = {"x": 2 * (params["x"] - target)}
        params, state, _ = adamw_update(grads, state, params, lr=5e-2,
                                        weight_decay=0.0)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clip():
    params = {"x": torch.zeros(4)}
    state = adamw_init(params)
    grads = {"x": torch.full((4,), 100.0)}
    _, _, norm = adamw_update(grads, state, params, lr=0.0, max_grad_norm=1.0)
    assert float(norm) == pytest.approx(200.0)


def test_schedule_shape():
    lr = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                              total_steps=100)) for s in range(100)]
    assert lr[0] == 0.0 and max(lr) == pytest.approx(1.0, abs=1e-3)
    assert lr[5] < lr[9]                       # warming up
    assert lr[99] < 0.2                        # decayed


def test_compression_error_feedback_unbiased():
    """With error feedback, the ACCUMULATED dequantized sum tracks the true
    gradient sum (residuals never vanish silently)."""
    rng = np.random.default_rng(0)
    grads_seq = [{"w": torch.tensor(rng.normal(size=(64,)), dtype=torch.float32)}
                 for _ in range(20)]
    state = init_compression(grads_seq[0])
    true_sum = np.zeros(64)
    deq_sum = np.zeros(64)
    for g in grads_seq:
        q, s, state = compress_tree(g, state)
        deq = decompress_tree(q, s)
        true_sum += g["w"].numpy()
        deq_sum += deq["w"].numpy()
    np.testing.assert_allclose(deq_sum + state.error["w"].numpy(), true_sum,
                               atol=1e-3)
