"""The port's DDS checkpoints (``repro_torch.storage.checkpoint``): ports of
the reference's ``CheckpointManager`` tests (``tests/test_substrates.py``)
on trees of tensors, and checkpoints crossing between the packages in
both directions, bf16 leaves included, each package's manager reading the
other's server.  The format is the same, so leaves are compared bit for
bit (bf16 through its 2-byte payload)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dds_server import DDSStorageServer as JaxDDSStorageServer
from repro.core.dds_server import ServerConfig as JaxServerConfig
from repro.storage.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.storage.checkpoint import _leaf_paths as jax_leaf_paths
from repro_torch.core.dds_server import DDSStorageServer, ServerConfig
from repro_torch.storage.checkpoint import CheckpointManager, _leaf_paths


@pytest.fixture()
def cm():
    return CheckpointManager(DDSStorageServer(ServerConfig()), keep=2)


def tree_of(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
                      "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))},
            "emb": torch.from_numpy(rng.normal(size=(32, 4)).astype(np.float32))}


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_save_restore_roundtrip(cm):
    t = tree_of()
    cm.save(5, t)
    assert cm.latest_step() == 5
    assert_tree_equal(cm.restore(5, t), t)


def test_atomic_commit_no_manifest_no_checkpoint(cm):
    """A crash before the manifest write leaves no visible checkpoint."""
    fe = cm.server.frontend
    fid = fe.create_file("ckpt-99/leaf")     # partial write, NO manifest
    fe.write_sync(fid, 0, b"partial")
    assert cm.latest_step() is None
    with pytest.raises(FileNotFoundError):
        cm.restore(99)


def test_elastic_restore_reshards(cm):
    t = tree_of()
    cm.save(7, t)
    for shards in (1, 2, 4):
        parts = [cm.restore_elastic(7, t, i, shards) for i in range(shards)]
        w = torch.cat([p["layer"]["w"] for p in parts], dim=0)
        assert torch.equal(w, t["layer"]["w"])
        assert torch.equal(parts[-1]["emb"], t["emb"][-32 // shards:])


def test_gc_keeps_latest(cm):
    for s in (1, 2, 3, 4):
        cm.save(s, tree_of(s))
    steps = sorted(cm._manifests())
    assert steps == [3, 4]                    # keep=2
    assert torch.equal(cm.restore(4, tree_of())["emb"], tree_of(4)["emb"])


def test_async_save(cm):
    t = tree_of()
    cm.save_async(11, t)
    t["emb"].zero_()       # the host copy was taken before save_async returned
    cm.wait_async()
    assert cm.latest_step() == 11
    assert torch.equal(cm.restore(11, t)["emb"], tree_of()["emb"])


# Crossing between the packages.


def _mixed(seed=0):
    """numpy leaves: fp32, bf16 (ml_dtypes, as JAX holds it), int32 and a
    0-d fp32, in a nested dict."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(6, 4)).astype(jnp.bfloat16),
                       "norm": rng.normal(size=(4,)).astype(jnp.bfloat16)},
            "mu": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                   "norm": rng.normal(size=(4,)).astype(np.float32)},
            "count": np.asarray(3, np.int32),
            "scale": np.asarray(0.5, np.float32)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _same_bits(t: torch.Tensor, a: np.ndarray):
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    if t.dtype == torch.bfloat16:
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(t.view(torch.uint16).numpy(), a.view(np.uint16))
    else:
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)


def _walk(a, b, fn):
    if isinstance(a, dict):
        for k in a:
            _walk(a[k], b[k], fn)
    else:
        fn(a, b)


def test_jax_checkpoint_restores_in_the_port():
    """The JAX manager saves on its server; the port's reads it back (its
    bf16 leaves as torch bf16, no ml_dtypes needed)."""
    server = JaxDDSStorageServer(JaxServerConfig())
    tree = _mixed()
    JaxCheckpointManager(server).save(4, tree)
    port = CheckpointManager(server)
    assert port.latest_step() == 4
    back = port.restore(4, _as_torch(tree))
    _walk(back, tree, _same_bits)
    assert back["params"]["w"].dtype == torch.bfloat16
    _same_bits(port.restore_shard(4, "params/w", 2, 4), tree["params"]["w"][2:4])


def test_port_checkpoint_restores_in_jax():
    """The port's manager saves torch bf16 leaves as their raw bytes on
    its server; the JAX manager reads them back as ml_dtypes bfloat16."""
    server = DDSStorageServer(ServerConfig())
    tree = _mixed(1)
    CheckpointManager(server).save(9, _as_torch(tree))
    jm = JaxCheckpointManager(server)
    assert jm.latest_step() == 9
    back = jm.restore(9, tree)
    _walk(_as_torch(back), tree, _same_bits)
    np.testing.assert_array_equal(np.asarray(back["params"]["w"], np.float32),
                                  np.asarray(tree["params"]["w"], np.float32))


class _State(NamedTuple):
    count: int
    mu: dict


def test_leaf_names_equal_jax_tree_paths():
    """Dict keys sorted, sequence entries by index, NamedTuple fields as
    ``.field``, None an empty subtree: the names
    ``jax.tree_util.tree_flatten_with_path`` gives."""
    tree = {"b": [np.zeros(1), (np.zeros(2), None)], "a": {"z": np.zeros(3),
            "y": _State(np.zeros(4), {"k": np.zeros(5)})}, "c": np.zeros(6)}
    ours = [(n, int(np.size(x))) for n, x in _leaf_paths(tree)]
    theirs = [(n, int(np.size(x))) for n, x in jax_leaf_paths(tree)]
    assert ours == theirs
    assert [n for n, _ in ours] == ["a/y/.count", "a/y/.mu/k", "a/z", "b/0",
                                    "b/1/0", "c"]
    assert _leaf_paths(np.zeros(2))[0][0] == jax_leaf_paths(np.zeros(2))[0][0] == "leaf"
    assert jax.tree_util.tree_structure(tree).num_leaves == len(ours)
