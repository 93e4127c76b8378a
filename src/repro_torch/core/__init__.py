"""DDS core — the paper's primary contribution (DPU-optimized storage path).

Layers (paper section in parens):
  ring          progressive lock-free DMA ring buffers (§4.1)
  wire          request/response encodings on the rings (Fig 9)
  file_service  DPU segment file system + zero-copy ordered execution (§4.3)
  host_lib      host front-end file library (§4.2)
  cache_table   cuckoo-hash cache table (§6.1)
  traffic       bump-in-the-wire traffic director + PEP splitting (§5)
  offload       offload engine: OffPred/OffFunc/Cache/Invalidate (§6)
  dds_server    the assembled storage server + benchmark client (§8.1)
  simulate      calibrated event model for DPU-hardware figures (§8)
"""

from repro_torch.core.cache_table import CacheTable
from repro_torch.core.client import ClusterClient, ShardConnection
from repro_torch.core.dds_server import DDSClient, DDSStorageServer, ServerConfig
from repro_torch.core.file_service import FileServiceRunner, SegmentFS
from repro_torch.core.host_lib import DDSFrontEnd
from repro_torch.core.offload import OffloadAPI, OffloadEngine, ReadOp, WriteOp
from repro_torch.core.ring import (DMAEngine, FaRMStyleRing, LockRing,
                             ProgressiveRing, ResponseRing)
from repro_torch.core.traffic import (ApplicationSignature, FiveTuple,
                                TrafficDirector)

__all__ = [
    "CacheTable", "ClusterClient", "ShardConnection",
    "DDSClient", "DDSStorageServer", "ServerConfig",
    "FileServiceRunner", "SegmentFS", "DDSFrontEnd", "OffloadAPI",
    "OffloadEngine", "ReadOp", "WriteOp", "DMAEngine", "FaRMStyleRing",
    "LockRing", "ProgressiveRing", "ResponseRing", "ApplicationSignature",
    "FiveTuple", "TrafficDirector",
]
