"""Applications built on the DDS cluster (the paper's §9 adoption story)."""

from repro_torch.apps.kv_store import KVClient, KVLocation, ShardedKVStore

__all__ = ["KVClient", "KVLocation", "ShardedKVStore"]
