"""Port's model layers against ``repro.models.layers``.

Inputs and weights come from numpy with a fixed seed and run in float32 on
both sides.  Tolerance: 1e-5 absolute and relative, a few float32 ulps of
the O(1) values compared (the two frameworks sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def test_rms_norm_scales_by_one_plus_w():
    rng = _rng(1)
    jx, tx = _both(rng.standard_normal((2, 5, 16), np.float32))
    jw, tw = _both(0.1 * rng.standard_normal(16).astype(np.float32))
    _close(TL.rms_norm(tx, tw), JL.rms_norm(jx, jw))
    # w = 0 is the identity scale, unlike torch.nn.RMSNorm's weight of 1.
    _close(TL.rms_norm(tx, torch.zeros(16)),
           tx * torch.rsqrt(tx.square().mean(-1, keepdim=True) + 1e-6))


def test_layer_norm():
    rng = _rng(2)
    jx, tx = _both(rng.standard_normal((2, 5, 16), np.float32))
    jw, tw = _both(rng.standard_normal(16).astype(np.float32))
    jb, tb = _both(rng.standard_normal(16).astype(np.float32))
    _close(TL.layer_norm(tx, tw, tb), JL.layer_norm(jx, jw, jb))


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_rotates_half_splits(offset):
    rng = _rng(3)
    jx, tx = _both(rng.standard_normal((2, 6, 3, 32), np.float32))
    pos = np.broadcast_to(np.arange(6) + offset, (2, 6)).astype(np.int32)
    jp, tp = _both(pos)
    _close(TL.apply_rope(tx, tp, 1e4), JL.apply_rope(jx, jp, 1e4))


def test_mrope():
    rng = _rng(4)
    jx, tx = _both(rng.standard_normal((1, 5, 2, 32), np.float32))
    pos3 = rng.integers(0, 50, (1, 5, 3)).astype(np.int32)
    jp, tp = _both(pos3)
    sections = JL._mrope_sections(32)
    assert TL._mrope_sections(32) == sections
    _close(TL.apply_mrope(tx, tp, 1e6, sections),
           JL.apply_mrope(jx, jp, 1e6, sections))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu"])
def test_mlp(kind):
    rng = _rng(5)
    d, f = 16, 32
    names = (["wi_gate", "wi_up"] if kind in ("swiglu", "geglu")
             else ["wi_up"])
    w = {n: (rng.standard_normal((d, f)) / 4).astype(np.float32) for n in names}
    w["wo"] = (rng.standard_normal((f, d)) / 6).astype(np.float32)
    jx, tx = _both(rng.standard_normal((2, 3, d), np.float32))
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    _close(TL.mlp_fwd(tp, tx, kind), JL.mlp_fwd(jp, jx, kind))


def _attn_params(cfg: TL.AttnConfig, seed=6):
    rng = _rng(seed)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
         "wo": (H * hd, D)}
    if cfg.qkv_bias:
        w.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    arrs = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in w.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _jnp_cfg(cfg: TL.AttnConfig) -> JL.AttnConfig:
    return JL.AttnConfig(**{f: getattr(cfg, f) for f in
                            TL.AttnConfig.__dataclass_fields__})


@pytest.mark.parametrize("window,bias", [(None, False), (8, True)])
def test_attention_fwd(window, bias):
    cfg = TL.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                        qkv_bias=bias, window=window, block_q=8, block_k=8)
    jp, tp = _attn_params(cfg)
    jx, tx = _both(_rng(7).standard_normal((2, 20, 32), np.float32))
    tout, (tk, tv) = TL.attention_fwd(tp, tx, cfg)
    jout, (jk, jv) = JL.attention_fwd(jp, jx, _jnp_cfg(cfg))
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("window,kv_len", [(None, 5), (4, 9)])
def test_attention_decode_writes_slot(window, kv_len):
    """Full caches write at kv_len; window rings at kv_len % window."""
    cfg = TL.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                        window=window)
    jp, tp = _attn_params(cfg, seed=8)
    rng = _rng(9)
    S_cache = window or 12
    kc = rng.standard_normal((2, S_cache, 2, 8), np.float32)
    vc = rng.standard_normal((2, S_cache, 2, 8), np.float32)
    jx, tx = _both(rng.standard_normal((2, 1, 32), np.float32))
    pos = np.full((2, 1), kv_len, np.int32)
    jout, jk, jv = JL.attention_decode(jp, jx, _jnp_cfg(cfg), jnp.asarray(kc),
                                       jnp.asarray(vc), kv_len,
                                       jnp.asarray(pos))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, tk2, tv2 = TL.attention_decode(tp, tx, cfg, tk, tv, kv_len,
                                         torch.from_numpy(pos))
    assert tk2 is tk and tv2 is tv            # written in place
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)
    slot = kv_len % S_cache if window else kv_len
    changed = np.nonzero(np.any(tk.numpy() != kc, axis=(0, 2, 3)))[0]
    assert changed.tolist() == [slot]


def test_embedding_tied_and_untied():
    rng = _rng(10)
    emb = rng.standard_normal((64, 16)).astype(np.float32)
    une = rng.standard_normal((16, 64)).astype(np.float32)
    tok = rng.integers(0, 64, (2, 5))
    jx, tx = _both(rng.standard_normal((2, 5, 16), np.float32))
    for params in ({"embed": emb}, {"embed": emb, "unembed": une}):
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        _close(TL.embed_fwd(tp, torch.from_numpy(tok)),
               JL.embed_fwd(jp, jnp.asarray(tok)))
        _close(TL.unembed_fwd(tp, tx), JL.unembed_fwd(jp, jx))


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
def test_maybe_remat_keeps_values_and_grads(policy):
    rng = _rng(11)
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))

    def body(x, w):
        return torch.tanh(x @ w) @ w

    grads = []
    for fn in (body, TL.maybe_remat(body, policy)):
        wr = w.clone().requires_grad_(True)
        out = fn(x, wr)
        out.square().sum().backward()
        grads.append((out.detach(), wr.grad))
    assert (TL.maybe_remat(body, policy) is body) == (policy == "none")
    _close(grads[1][0], grads[0][0].numpy())
    _close(grads[1][1], grads[0][1].numpy())


def test_inits_match_jax_shapes_dtypes_and_axes():
    import jax
    cfg = TL.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                        qkv_bias=True)
    g = torch.Generator().manual_seed(0)
    cases = [
        (TL.init_attention(g, cfg), JL.init_attention(jax.random.PRNGKey(0),
                                                      _jnp_cfg(cfg))),
        (TL.init_mlp(g, 32, 64, "swiglu"),
         JL.init_mlp(jax.random.PRNGKey(0), 32, 64, "swiglu")),
        (TL.init_embedding(g, 256, 32), JL.init_embedding(jax.random.PRNGKey(0),
                                                         256, 32)),
    ]
    for (tp, ta), (jp, ja) in cases:
        assert ta == ja
        assert tp.keys() == jp.keys()
        for k in tp:
            assert tuple(tp[k].shape) == jp[k].shape
            assert tp[k].dtype == torch.bfloat16 and jp[k].dtype == jnp.bfloat16
    # fan-in scale: std of wq is d_model**-0.5
    wq = TL.init_attention(g, TL.AttnConfig(512, 8, 8, 64))[0]["wq"].float()
    assert abs(wq.std().item() - 512 ** -0.5) < 2e-3
