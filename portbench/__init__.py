"""The port's benchmark: one harness driven by the files beside it."""
