"""Distribution layer: sharding rules, fault tolerance, elasticity, and the
multi-server DDS cluster (consistent-hash sharded storage scale-out)."""

from repro_torch.distributed.cluster import (DDSCluster, FileLocation, HashRing,
                                       stable_hash)

__all__ = ["DDSCluster", "FileLocation", "HashRing", "stable_hash"]
