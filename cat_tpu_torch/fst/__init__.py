"""Language-model pieces of the port (the n-gram LM for the CTC-CRF
denominator)."""
