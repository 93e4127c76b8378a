"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, on the CPU without ranks.

Every rule function must give the reference's specs exactly, compared as
tuples, on the mesh stand-ins of ``tests/test_sharding_rules.py``
(``{"data": 16, "model": 16}`` and ``{"pod": 2, "data": 16, "model":
16}``): parameter specs with FSDP on and off for every architecture,
batch specs for every workload shape, cache specs on every family's decode
cache at ``decode_32k`` and ``long_500k``, ``sanitize_spec`` under
hypothesis, ``dp_axes`` with skipped axes and serving's ``_ndp``.  Also:
``to_placements``, and the activation hooks are identities outside a
scope and on plain tensors inside one.
"""

import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.distributed import sharding as jsh
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import _ndp as jax_ndp
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import _ndp
from repro_torch.tree import leaf_paths


class FakeMesh:
    """Mesh stand-in: sharding rules only read .axis_names and .shape."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
FAMILIES = ["tinyllama_1p1b", "granite_moe_3b_a800m", "rwkv6_7b",
            "zamba2_1p2b", "seamless_m4t_medium", "gemma3_4b", "qwen2_vl_72b"]


def _flat_jax(tree):
    """[(path of keys/indices, spec as a tuple)] of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path),
             tuple(spec)) for path, spec in flat]


def _flat_port(tree):
    out = []

    def walk(t, path):
        if isinstance(t, P):
            out.append((path, tuple(t)))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def axes_trees():
    """arch -> (port axes tree, JAX axes tree) of the reduced init."""
    out = {}
    for arch in ARCH_IDS:
        _, taxes = build_model(reduced_config(get_config(arch)), "cpu").init(
            torch.Generator().manual_seed(0))
        jcfg = jax_reduced_config(jax_get_config(arch))
        captured = {}

        def initfn(k, jcfg=jcfg):
            p, a = jax_build_model(jcfg).init(k)
            captured["axes"] = a
            return p

        jax.eval_shape(initfn, jax.random.PRNGKey(0))
        out[arch] = (taxes, captured["axes"])
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(axes_trees, arch, fsdp, mesh):
    taxes, jaxes = axes_trees[arch]
    m = MESHES[mesh]
    port = sh.param_specs(taxes, m, get_config(arch), fsdp=fsdp)
    ref = jsh.param_specs(jaxes, m, jax_get_config(arch), fsdp=fsdp)
    assert _flat_port(port) == _flat_jax(ref)
    assert len(_flat_port(port)) > 3


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_specs_equal_reference(shape, mesh):
    m = MESHES[mesh]
    port = sh.batch_specs(m, TSHAPES[shape], get_config("tinyllama_1p1b"))
    ref = jsh.batch_specs(m, SHAPES[shape], jax_get_config("tinyllama_1p1b"))
    assert sorted(port) == sorted(ref)
    for k in ref:
        if k == "cache":
            assert (port[k].batch_ax, port[k].seq_ax) == (ref[k].batch_ax,
                                                          ref[k].seq_ax)
            continue
        assert tuple(port[k]) == tuple(ref[k]), k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_equal_reference(arch, shape, mesh):
    m = MESHES[mesh]
    tcache = build_model(get_config(arch), "cpu").input_specs(TSHAPES[shape])["cache"]
    jcache = jax_build_model(jax_get_config(arch)).input_specs(SHAPES[shape])["cache"]
    port = sh.cache_specs(tcache, m, get_config(arch), TSHAPES[shape])
    ref = jsh.cache_specs(jcache, m, jax_get_config(arch), SHAPES[shape])
    assert _flat_port(port) == _flat_jax(ref)
    assert [p for p, _ in leaf_paths(tcache)] == [p for p, _ in _flat_port(port)]


ENTRY = st.sampled_from(["data", "model", "pod", None, ("pod", "data"),
                         ("data", "model")])


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(1, 4096), min_size=1, max_size=4),
       st.lists(ENTRY, min_size=0, max_size=4), st.sampled_from(list(MESHES)))
def test_sanitize_spec_equals_reference(shape, entries, mesh):
    m = MESHES[mesh]
    if "pod" not in m.shape:
        entries = [e for e in entries if e is None or "pod" not in e]
    entries = entries[: len(shape)]
    port = sh.sanitize_spec(P(*entries), tuple(shape), m)
    ref = jsh.sanitize_spec(JP(*entries), tuple(shape), m)
    assert tuple(port) == tuple(ref)


@pytest.mark.parametrize("skip", [frozenset(), frozenset({"pod"}),
                                  frozenset({"data"}), frozenset({"pod", "data"})])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_axes_with_skipped_axes_equal_reference(mesh, skip):
    m = MESHES[mesh]
    with sh.activation_sharding_scope(m, "train", skip_axes=skip):
        port = sh.dp_axes(m)
    with jsh.activation_sharding_scope(m, "train", skip_axes=skip):
        ref = jsh.dp_axes(m)
    assert port == ref


@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_data_parallel_size_equals_reference(mesh):
    assert _ndp(MESHES[mesh]) == jax_ndp(MESHES[mesh]) > 1


@pytest.mark.parametrize("spec,mesh,want", [
    (P("data", None), {"data": 2, "model": 2}, [Shard(0), Replicate()]),
    (P(None, "model"), {"data": 2, "model": 2}, [Replicate(), Shard(1)]),
    (P(("pod", "data"), None, "model"), {"pod": 2, "data": 2, "model": 2},
     [Shard(0), Shard(0), Shard(2)]),
    (P(None, P.UNCONSTRAINED), {"data": 2, "model": 2}, [Replicate(), Replicate()]),
    (P("data", "model"), {"data": 1, "model": 2}, [Replicate(), Shard(1)]),
    (P(), {"data": 2, "model": 2}, [Replicate(), Replicate()]),
])
def test_to_placements(spec, mesh, want):
    assert sh.to_placements(spec, FakeMesh(mesh)) == want


HOOKS = {"constrain_batch": sh.constrain_batch,
         "constrain_logits": sh.constrain_logits,
         "gather_fsdp": lambda x: sh.gather_fsdp(x, tp_dim=1),
         "constrain_kv_layout": sh.constrain_kv_layout,
         "replicate_dim": lambda x: sh.replicate_dim(x, -1),
         "like": lambda x: sh.like(x, x),
         "on_mesh_of": lambda x: sh.on_mesh_of(x, x)}


@pytest.mark.parametrize("scoped", [False, True])
@pytest.mark.parametrize("hook", list(HOOKS))
def test_hooks_return_plain_tensors_untouched(hook, scoped):
    x = torch.randn(4, 8, 2, 16)
    if scoped:
        with sh.activation_sharding_scope(MESHES["16x16"], "train"):
            assert HOOKS[hook](x) is x
    else:
        assert HOOKS[hook](x) is x


def test_spec_entries_are_canonical_as_in_jax():
    assert tuple(P(("data",), None)) == tuple(JP(("data",), None)) == ("data", None)
    assert tuple(P(["pod", "data"])) == tuple(JP(("pod", "data"))) == (("pod", "data"),)


def test_param_shardings_are_the_placements_of_param_specs(axes_trees):
    taxes, _ = axes_trees["granite_moe_3b_a800m"]
    m = FakeMesh({"data": 2, "model": 2})
    specs = _flat_port(sh.param_specs(taxes, m, get_config("granite_moe_3b_a800m")))
    got = sh.param_shardings(taxes, m, get_config("granite_moe_3b_a800m"))
    want = {path: sh.to_placements(P(*spec), m) for path, spec in specs}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                yield from walk(t[k], path + (k,))
        else:
            yield path, t
    assert dict(walk(got)) == want
