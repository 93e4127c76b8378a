"""Storage substrates: block device model, page store, checkpointing."""
