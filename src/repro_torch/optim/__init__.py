"""Optimizers, LR schedules, gradient compression."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.optim.compression import (CompressionState, compress_tree,
                                           decompress_tree, init_compression)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "warmup_cosine",
           "CompressionState", "compress_tree", "decompress_tree",
           "init_compression"]
