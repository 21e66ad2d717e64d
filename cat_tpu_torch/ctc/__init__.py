"""CTC model assembly and decoding."""
