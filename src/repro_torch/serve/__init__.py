"""Serving: continuous batching and DDS-backed KV paging."""
