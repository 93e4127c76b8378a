"""Data pipeline substrate."""
