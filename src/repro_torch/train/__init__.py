"""Training loop layer."""
