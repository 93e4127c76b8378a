"""Model layers, the decoder-only LM and the model registry."""
