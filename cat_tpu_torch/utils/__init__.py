"""Host-side utilities of the port: checkpoints, tokenizers, data, and
the converter of JAX parameters."""
